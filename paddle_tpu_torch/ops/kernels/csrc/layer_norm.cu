// LayerNorm forward (training and inference) and backward for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/layer_norm.py:
// `_fwd_kernel` (pl.pallas_call at line 92, `_fwd`), `_infer_kernel` (line
// 119, `_infer`) and `_bwd_kernel` (line 137, `_bwd`). Same results: row
// statistics in f32 with a two-pass variance mean((x - mu)^2) (no Welford),
// rstd = rsqrt(var + eps), the affine (x - mu) * rstd * g + b in f32 and one
// cast to x's dtype at the end; the backward recomputes xhat from the saved
// mu and rstd and gives dx = (g*dy - mean(g*dy) - xhat * mean(g*dy*xhat)) *
// rstd, dg = sum_rows dy * xhat and db = sum_rows dy in f32. mu and rstd are
// [n] f32 (the TPU's 128-lane broadcast [n, 128] is a layout matter). g and b
// come in as f32 (the wrapper widens them; the TPU kernel widens them in its
// body).
//
// Layout: a group of W warps (W = 1 up to h = 1024, 2, 4 or 8 up to 8192)
// holds one row in registers, NV chunks of 4 consecutive elements a lane
// (16-byte loads in f32, 8-byte in bf16); a CTA of 256 threads takes 256 /
// (32 W) rows. Row sums reduce with warp shuffles, then across the group's
// warps in shared memory, always in the same order. Forward and inference are
// one kernel, templated on whether it writes mu and rstd.
//
// dg and db: the TPU adds every grid step's sums into one [1, h] block that
// the sequential grid revisits. CTAs run in parallel here, so each CTA of the
// backward walks a fixed set of row blocks, keeps its column sums in
// registers (a lane owns the same columns in every row), adds its groups in
// shared memory in a fixed order and writes one f32 partial row per CTA; a
// second kernel of this file sums the partials column by column in a fixed
// order. No atomics: the results are deterministic.
//
// Bound at GPT-2 124M's [8 * 1024, 768]: bytes. f32 forward: x read and o
// written, 50.3 MB (+ 64 KB of mu, rstd) = 15.0 us at 3.35 TB/s; bf16 7.5 us.
// f32 backward: x, dy read and dx written, 75.5 MB = 22.5 us. The flops
// (about 10 a element) are far below the FP32 units' rate. What the design
// does about it: every tensor is read once and written once, rows stay in
// registers between the passes, and the dg/db partials add 2 x 264 x h f32
// (1.6 MB at h = 768).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads a CTA
constexpr int BWD_CTAS = 264;  // the backward's CTAs at most (2 a SM); partial rows
constexpr int MAX_H = 8192;

template <typename T> struct Io;

template <> struct Io<float> {
  static __device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
    // round to nearest even, as astype does
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned int*>(&a);
    u.y = *reinterpret_cast<unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum over the W warps of a group: every thread of the CTA must call it (it
// synchronises the CTA when W > 1). red holds [NT / 32] floats.
template <int W>
__device__ __forceinline__ float group_sum(float x, float* red) {
  x = warp_sum(x);
  if constexpr (W == 1) {
    return x;
  } else {
    const int warp = threadIdx.x >> 5;
    const int first = warp - warp % W;
    __syncthreads();  // earlier reads of red are done
    if ((threadIdx.x & 31) == 0) red[warp] = x;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) s += red[first + w];
    return s;
  }
}

template <typename T, int W, int NV, bool STATS>
__global__ void __launch_bounds__(NT) ln_fwd_kernel(const T* __restrict__ x,
                                                    const float* __restrict__ g,
                                                    const float* __restrict__ b,
                                                    T* __restrict__ o, float* __restrict__ mu_out,
                                                    float* __restrict__ rstd_out, int n, int h,
                                                    float eps) {
  constexpr int L = 32 * W;   // lanes of a row
  constexpr int G = NT / L;   // rows a CTA
  __shared__ float red[NT / 32];
  const int lane = threadIdx.x % L;
  const int row = blockIdx.x * G + threadIdx.x / L;
  const bool live = row < n;
  const int h4 = h / 4;
  const T* xr = x + static_cast<long long>(row) * h;

  float v[NV][4];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int k = c * L + lane;
    if (live && k < h4) {
      Io<T>::load4(xr + 4 * k, v[c]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[c][q] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) s += v[c][q];
  }
  const float mean = group_sum<W>(s, red) / static_cast<float>(h);

  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const bool ok = c * L + lane < h4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[c][q] = ok ? v[c][q] - mean : 0.f;
      ss += v[c][q] * v[c][q];
    }
  }
  const float var = group_sum<W>(ss, red) / static_cast<float>(h);
  const float rstd = rsqrtf(var + eps);

  if (!live) return;
  T* orow = o + static_cast<long long>(row) * h;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int k = c * L + lane;
    if (k < h4) {
      const float4 gg = *reinterpret_cast<const float4*>(g + 4 * k);
      const float4 bb = *reinterpret_cast<const float4*>(b + 4 * k);
      const float gv[4] = {gg.x, gg.y, gg.z, gg.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
      float out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        out[q] = __fadd_rn(__fmul_rn(__fmul_rn(v[c][q], rstd), gv[q]), bv[q]);
      Io<T>::store4(orow + 4 * k, out);
    }
  }
  if (STATS && lane == 0) {
    mu_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// dx for every row; per-CTA partial column sums of dy * xhat and dy into
// part[0][blockIdx.x][:] and part[1][blockIdx.x][:].
template <typename T, int W, int NV>
__global__ void __launch_bounds__(NT) ln_bwd_kernel(const T* __restrict__ x,
                                                    const float* __restrict__ g,
                                                    const T* __restrict__ dy,
                                                    const float* __restrict__ mu,
                                                    const float* __restrict__ rstd,
                                                    T* __restrict__ dx, float* __restrict__ part,
                                                    int n, int h) {
  constexpr int L = 32 * W;
  constexpr int G = NT / L;
  __shared__ float red[NT / 32];
  __shared__ float colsum[MAX_H];  // [G][h]: G * h <= 8192
  const int lane = threadIdx.x % L;
  const int grp = threadIdx.x / L;
  const int h4 = h / 4;
  const float hf = static_cast<float>(h);

  float gam[NV][4], acc_g[NV][4], acc_b[NV][4];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int k = c * L + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gam[c][q] = k < h4 ? g[4 * k + q] : 0.f;
      acc_g[c][q] = acc_b[c][q] = 0.f;
    }
  }

  const int n_blocks = (n + G - 1) / G;
  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {  // uniform over the CTA
    const int row = rb * G + grp;
    const bool live = row < n;
    const long long off = static_cast<long long>(row) * h;
    const float m = live ? mu[row] : 0.f;
    const float r = live ? rstd[row] : 0.f;
    float xh[NV][4], dv[NV][4];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int k = c * L + lane;
      if (live && k < h4) {
        Io<T>::load4(x + off + 4 * k, xh[c]);
        Io<T>::load4(dy + off + 4 * k, dv[c]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) xh[c][q] = dv[c][q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xh[c][q] = (xh[c][q] - m) * r;            // xhat (0 past the row)
        const float wdy = dv[c][q] * gam[c][q];
        s1 += wdy;
        s2 += wdy * xh[c][q];
        acc_g[c][q] += dv[c][q] * xh[c][q];
        acc_b[c][q] += dv[c][q];
      }
    }
    const float c1 = group_sum<W>(s1, red) / hf;
    const float c2 = group_sum<W>(s2, red) / hf;
    if (live) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int k = c * L + lane;
        if (k < h4) {
          float out[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            out[q] = (dv[c][q] * gam[c][q] - c1 - xh[c][q] * c2) * r;
          Io<T>::store4(dx + off + 4 * k, out);
        }
      }
    }
  }

  // the CTA's column sums: groups in order 0..G-1, then one partial row
  for (int which = 0; which < 2; ++which) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int k = c * L + lane;
      if (k < h4) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          colsum[grp * h + 4 * k + q] = which == 0 ? acc_g[c][q] : acc_b[c][q];
      }
    }
    __syncthreads();
    float* dst = part + (static_cast<long long>(which) * gridDim.x + blockIdx.x) * h;
    for (int col = threadIdx.x; col < h; col += NT) {
      float s = 0.f;
      for (int gi = 0; gi < G; ++gi) s += colsum[gi * h + col];
      dst[col] = s;
    }
  }
}

// out[which][col] = sum over p of part[which][p][col], p in order, for which
// in {0: dg, 1: db}. Block (32, 8): column tx of the block's 32, ty takes
// every 8th partial row; the 8 sums are added in order.
__global__ void __launch_bounds__(NT) ln_colsum_kernel(const float* __restrict__ part, int parts,
                                                       int h, float* __restrict__ out) {
  __shared__ float s[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  const float* src = part + static_cast<long long>(blockIdx.y) * parts * h;
  float acc = 0.f;
  if (col < h)
    for (int p = ty; p < parts; p += 8) acc += src[static_cast<long long>(p) * h + col];
  s[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < h) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += s[i][tx];
    out[blockIdx.y * h + col] = t;
  }
}

// W warps a row and NV chunks a lane for hidden size h (a multiple of 128)
bool shape_for(int h, int* w, int* nv) {
  if (h <= 0 || h % 128 != 0 || h > MAX_H) return false;
  int warps = 1;
  while (warps * 1024 < h) warps *= 2;
  const int need = (h / 4 + 32 * warps - 1) / (32 * warps);  // chunks a lane
  *w = warps;
  *nv = need <= 2 ? 2 : need <= 4 ? 4 : need <= 6 ? 6 : 8;
  return true;
}

template <typename T, int W, int NV>
cudaError_t fwd_launch(const void* x, const float* g, const float* b, void* o, float* mu,
                       float* rstd, int n, int h, float eps, bool stats, cudaStream_t st) {
  constexpr int G = NT / (32 * W);
  const int grid = (n + G - 1) / G;
  if (stats)
    ln_fwd_kernel<T, W, NV, true><<<grid, NT, 0, st>>>(
        static_cast<const T*>(x), g, b, static_cast<T*>(o), mu, rstd, n, h, eps);
  else
    ln_fwd_kernel<T, W, NV, false><<<grid, NT, 0, st>>>(
        static_cast<const T*>(x), g, b, static_cast<T*>(o), nullptr, nullptr, n, h, eps);
  return cudaGetLastError();
}

template <typename T, int W, int NV>
cudaError_t bwd_launch(const void* x, const float* g, const void* dy, const float* mu,
                       const float* rstd, void* dx, float* part, int parts, float* dgdb, int n,
                       int h, cudaStream_t st) {
  ln_bwd_kernel<T, W, NV><<<parts, NT, 0, st>>>(static_cast<const T*>(x), g,
                                                static_cast<const T*>(dy), mu, rstd,
                                                static_cast<T*>(dx), part, n, h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ln_colsum_kernel<<<dim3((h + 31) / 32, 2), NT, 0, st>>>(part, parts, h, dgdb);
  return cudaGetLastError();
}

// the (W, NV) instantiations shape_for can pick
#define LN_DISPATCH(FN, T, ...)                                             \
  switch (w * 16 + nv) {                                                    \
    case 1 * 16 + 2: return FN<T, 1, 2>(__VA_ARGS__);                       \
    case 1 * 16 + 4: return FN<T, 1, 4>(__VA_ARGS__);                       \
    case 1 * 16 + 6: return FN<T, 1, 6>(__VA_ARGS__);                       \
    case 1 * 16 + 8: return FN<T, 1, 8>(__VA_ARGS__);                       \
    case 2 * 16 + 6: return FN<T, 2, 6>(__VA_ARGS__);                       \
    case 2 * 16 + 8: return FN<T, 2, 8>(__VA_ARGS__);                       \
    case 4 * 16 + 6: return FN<T, 4, 6>(__VA_ARGS__);                       \
    case 4 * 16 + 8: return FN<T, 4, 8>(__VA_ARGS__);                       \
    case 8 * 16 + 6: return FN<T, 8, 6>(__VA_ARGS__);                       \
    case 8 * 16 + 8: return FN<T, 8, 8>(__VA_ARGS__);                       \
    default: return cudaErrorInvalidValue;                                  \
  }

template <typename T>
cudaError_t fwd_dispatch(int w, int nv, const void* x, const float* g, const float* b, void* o,
                         float* mu, float* rstd, int n, int h, float eps, bool stats,
                         cudaStream_t st) {
  LN_DISPATCH(fwd_launch, T, x, g, b, o, mu, rstd, n, h, eps, stats, st)
}

template <typename T>
cudaError_t bwd_dispatch(int w, int nv, const void* x, const float* g, const void* dy,
                         const float* mu, const float* rstd, void* dx, float* part, int parts,
                         float* dgdb, int n, int h, cudaStream_t st) {
  LN_DISPATCH(bwd_launch, T, x, g, dy, mu, rstd, dx, part, parts, dgdb, n, h, st)
}

}  // namespace

// x, o: [n, h] contiguous, dtype 0 = float32, 1 = bfloat16; g, b: [h] f32;
// mu, rstd: [n] f32, written when stats != 0 (the training forward), else
// unused (the inference forward). h a multiple of 128, at most 8192. Returns
// cudaGetLastError() of the launch.
extern "C" int layer_norm_fwd(const void* x, const void* g, const void* b, void* o, void* mu,
                              void* rstd, int dtype, int n, int h, float eps, int stats,
                              void* stream) {
  int w, nv;
  if (!shape_for(h, &w, &nv)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  float* muf = static_cast<float*>(mu);
  float* rf = static_cast<float*>(rstd);
  cudaError_t e;
  if (dtype == 0)
    e = fwd_dispatch<float>(w, nv, x, gf, bf, o, muf, rf, n, h, eps, stats != 0, st);
  else if (dtype == 1)
    e = fwd_dispatch<__nv_bfloat16>(w, nv, x, gf, bf, o, muf, rf, n, h, eps, stats != 0, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The number of partial rows (and CTAs) the backward uses for n rows.
extern "C" int layer_norm_bwd_parts(int n) {
  const int p = (n + 7) / 8;
  return p < BWD_CTAS ? (p > 0 ? p : 1) : BWD_CTAS;
}

// x, dy, dx: [n, h] contiguous in x's dtype; g: [h] f32; mu, rstd: [n] f32
// from the training forward; part: [2, parts, h] f32 scratch with parts =
// layer_norm_bwd_parts(n); dgdb: [2, h] f32 out (dg, then db). Launches the
// backward, then the column sum of the partials. Returns cudaGetLastError().
extern "C" int layer_norm_bwd(const void* x, const void* g, const void* dy, const void* mu,
                              const void* rstd, void* dx, void* part, void* dgdb, int dtype,
                              int n, int h, int parts, void* stream) {
  int w, nv;
  if (!shape_for(h, &w, &nv) || parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* muf = static_cast<const float*>(mu);
  const float* rf = static_cast<const float*>(rstd);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(dgdb);
  cudaError_t e;
  if (dtype == 0)
    e = bwd_dispatch<float>(w, nv, x, gf, dy, muf, rf, dx, pf, parts, of, n, h, st);
  else if (dtype == 1)
    e = bwd_dispatch<__nv_bfloat16>(w, nv, x, gf, dy, muf, rf, dx, pf, parts, of, n, h, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
