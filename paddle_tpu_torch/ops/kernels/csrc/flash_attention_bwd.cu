// Flash-attention backward for Hopper (sm_90a), CUDA C++: the FA2 dK/dV and
// dQ kernels.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
// `_bwd_dkdv_kernel` and `_bwd_dq_kernel` (pl.pallas_call at lines 242 and
// 268 in `_bwd`). Same results: S = (q . k) in f32, times scale; causal masks
// kpos > qpos (top-left aligned) with the finite NEG_INF = -1e30; P =
// exp(S - lse) with the forward's lse (m and l are not recomputed); dP = dO .
// V in f32; dS = P * (dP - delta) * scale; P is rounded to dO's dtype before
// P^T . dO and dS to the q/k dtype before dS^T . Q and dS . K; accumulators
// are f32 and outputs take the input dtype. delta = rowsum(dO * O) (minus the
// lse cotangent) comes from the caller, as the TPU version computes it
// outside its kernels.
//
// Split (as on the TPU, with no atomics, so results are deterministic):
//   dkdv: one CTA per (b*h, 64-row kv tile); a loop over 64-row q tiles,
//         starting at the first one the causal mask leaves visible, carries
//         dK and dV in registers. (The TPU carries them in VMEM scratch across
//         a sequential grid axis.)
//   dq:   one CTA per (b*h, 64-row q tile); a loop over kv tiles up to the
//         diagonal carries dQ in registers.
// Thread (ty = tid/16, tx = tid%16) of 128 owns 8 rows of the CTA's own tile
// (kv rows for dkdv, q rows for dq) and, for the S and dP tiles, the 4 columns
// tx+16j of the other side; the operand of its own side is staged transposed
// in shared memory so its 8 rows load as two 16-byte words. P and dS go
// through shared memory once, laid out so the accumulating products read 8
// consecutive rows the same way. Inputs are read through their strides (the
// model's q, k, v are views of one fused projection); only the last dim must
// be contiguous. Ragged sq and sk are masked.
//
// Bound at the training shape (b=8, h=12, s=1024, d=64, causal): the FA2
// backward needs 5 products of 2*d*b*h*s*(s+1)/2 = 6.45 GFLOP each (S, dP,
// dV, dK, dQ: 32.2 GFLOP); split into two kernels, dkdv does 4 (25.8 GFLOP)
// and dq 3 (19.3 GFLOP), since each recomputes S and dP. On the FP32 units
// (67 TFLOP/s, no TF32) that is 0.385 ms for dkdv and 0.289 ms for dq; in
// bf16 on tensor cores (989 TFLOP/s) both would be bound by bytes (~25 us).
// This first version does every product with FMA on the FP32 units (bf16 is
// widened to f32 in shared memory), so its floor is the f32 one in both
// dtypes. What the design does about it: each CTA reads its own tile from
// device memory once and the other side's tiles once each per loop step,
// reusing them from shared memory for 64 rows; S, P, dP and dS never leave
// the chip; the causal skip halves the work; causal CTAs with the most work
// are launched first. mma.sync and then wgmma with TMA are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // q rows per tile
constexpr int BK = 64;            // kv rows per tile
constexpr int NTHREADS = 128;
constexpr int ROWS = 8;           // own-tile rows per thread
constexpr int COLS = 4;           // S / dP columns per thread
constexpr int TSTRIDE = 64 + 4;   // row stride of transposed tiles (16-byte aligned)
constexpr float NEG_INF = -1e30f;
static_assert(BQ == 64 && BK == 64, "the thread layout covers 64 x 64 tiles");

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to T and widened back (the reference's .astype before a product)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [b*h, sq] contiguous
  const float* delta;  // [b*h, sq] contiguous
  void* dq;
  void* dk;
  void* dv;
  int heads, sq, sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ void load_rows8(const float* src, float (&dst)[ROWS]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

// rows [r0, r0 + 64) of a [s, D] strided tile into shared memory, transposed
// ([D][TSTRIDE]); rows past n are zero
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(const T* src, long long row_stride,
                                                 int r0, int n, float* dst) {
  for (int i = threadIdx.x; i < 64 * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const int g = r0 + r;
    dst[c * TSTRIDE + r] = g < n ? to_f(src[g * row_stride + c]) : 0.f;
  }
}

// the same rows kept row-major with a padded stride ([64][D + 1])
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* src, long long row_stride, int r0,
                                           int n, float* dst) {
  for (int i = threadIdx.x; i < 64 * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const int g = r0 + r;
    dst[r * (D + 1) + c] = g < n ? to_f(src[g * row_stride + c]) : 0.f;
  }
}

template <int D>
constexpr int dkdv_smem_floats() {
  // Kt, Vt [D][TSTRIDE]; Q, dO [64][D+1]; P, dS [64][TSTRIDE]; lse, delta [64]
  return 2 * D * TSTRIDE + 2 * 64 * (D + 1) + 2 * 64 * TSTRIDE + 2 * 64;
}

template <int D>
constexpr int dq_smem_floats() {
  // Qt, dOt [D][TSTRIDE]; K, V [64][D+1]; dS^T [64][TSTRIDE]
  return 2 * D * TSTRIDE + 2 * 64 * (D + 1) + 64 * TSTRIDE;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkdv_kernel(const Params p) {
  constexpr int DC = D / 16;  // dK / dV columns per thread
  extern __shared__ float4 smem4[];
  float* sKt = reinterpret_cast<float*>(smem4);  // [D][TSTRIDE]  K transposed
  float* sVt = sKt + D * TSTRIDE;                // [D][TSTRIDE]  V transposed
  float* sQ = sVt + D * TSTRIDE;                 // [BQ][D + 1]
  float* sdO = sQ + BQ * (D + 1);                // [BQ][D + 1]
  float* sP = sdO + BQ * (D + 1);                // [BQ][TSTRIDE]  P[q][k], rounded
  float* sdS = sP + BQ * TSTRIDE;                // [BQ][TSTRIDE]  dS[q][k], rounded
  float* sLse = sdS + BQ * TSTRIDE;              // [BQ]
  float* sDelta = sLse + BQ;                     // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * BK;  // causal: the first kv tiles see the most q tiles

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.sq;

  stage_transposed<T, D>(k, p.k_ss, k0, p.sk, sKt);
  stage_transposed<T, D>(v, p.v_ss, k0, p.sk, sVt);

  float acc_dk[ROWS][DC], acc_dv[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  // causal: q tiles that end before this kv tile starts see none of it
  const int n_q = (p.sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? k0 / BQ : 0;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's reads of sQ, sdO, sP, sdS are done
    stage_rows<T, D>(q, p.q_ss, q0, p.sq, sQ);
    stage_rows<T, D>(dout, p.do_ss, q0, p.sq, sdO);
    if (tid < BQ) {
      const int qr = q0 + tid;
      sLse[tid] = qr < p.sq ? lse[qr] : 0.f;
      sDelta[tid] = qr < p.sq ? delta[qr] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for kv rows ty*8+i, q columns tx+16j
    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[ROWS], vv[ROWS], qv[COLS], dov[COLS];
      load_rows8(sKt + d * TSTRIDE + ty * ROWS, kv);
      load_rows8(sVt + d * TSTRIDE + ty * ROWS, vv);
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        qv[j] = sQ[(tx + 16 * j) * (D + 1) + d];
        dov[j] = sdO[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

    // P = exp(S*scale - lse), dS = P (dP - delta) scale; rows and columns
    // past the ends contribute exactly 0
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int kl = ty * ROWS + i;
      const int kpos = k0 + kl;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int ql = tx + 16 * j;
        const int qpos = q0 + ql;
        float x = s[i][j] * p.scale;
        if (p.causal && kpos > qpos) x = NEG_INF;
        float pr = expf(x - sLse[ql]);
        if (qpos >= p.sq || kpos >= p.sk) pr = 0.f;
        const float ds = pr * (dp[i][j] - sDelta[ql]) * p.scale;
        sP[ql * TSTRIDE + kl] = round_to<T>(pr);
        sdS[ql * TSTRIDE + kl] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q for kv rows ty*8+i, columns tx*DC+c
    const int q_hi = min(BQ, p.sq - q0);
#pragma unroll 4
    for (int qq = 0; qq < q_hi; ++qq) {
      float pv[ROWS], dsv[ROWS], dov[DC], qv[DC];
      load_rows8(sP + qq * TSTRIDE + ty * ROWS, pv);
      load_rows8(sdS + qq * TSTRIDE + ty * ROWS, dsv);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dov[c] = sdO[qq * (D + 1) + tx * DC + c];
        qv[c] = sQ[qq * (D + 1) + tx * DC + c];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_dv[i][c] = fmaf(pv[i], dov[c], acc_dv[i][c]);
          acc_dk[i][c] = fmaf(dsv[i], qv[c], acc_dk[i][c]);
        }
    }
  }

  T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = k0 + ty * ROWS + i;
    if (row < p.sk) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dk[row * p.dk_ss + tx * DC + c] = from_f<T>(acc_dk[i][c]);
        dv[row * p.dv_ss + tx * DC + c] = from_f<T>(acc_dv[i][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Params p) {
  constexpr int DC = D / 16;  // dQ columns per thread
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);  // [D][TSTRIDE]  Q transposed
  float* sdOt = sQt + D * TSTRIDE;               // [D][TSTRIDE]  dO transposed
  float* sK = sdOt + D * TSTRIDE;                // [BK][D + 1]
  float* sV = sK + BK * (D + 1);                 // [BK][D + 1]
  float* sdSt = sV + BK * (D + 1);               // [BK][TSTRIDE]  dS[k][q], rounded

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.sq;

  stage_transposed<T, D>(q, p.q_ss, q0, p.sq, sQt);
  stage_transposed<T, D>(dout, p.do_ss, q0, p.sq, sdOt);

  float row_lse[ROWS], row_delta[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qr = q0 + ty * ROWS + i;
    row_lse[i] = qr < p.sq ? lse[qr] : 0.f;
    row_delta[i] = qr < p.sq ? delta[qr] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: kv tiles starting past this tile's last query row contribute nothing
  int n_kv = (p.sk + BK - 1) / BK;
  if (p.causal) {
    const int last_q = min(q0 + BQ, p.sq) - 1;
    n_kv = min(n_kv, last_q / BK + 1);
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of sK, sV, sdSt are done
    stage_rows<T, D>(k, p.k_ss, k0, p.sk, sK);
    stage_rows<T, D>(v, p.v_ss, k0, p.sk, sV);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for q rows ty*8+i, kv columns tx+16j
    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], dov[ROWS], kv[COLS], vv[COLS];
      load_rows8(sQt + d * TSTRIDE + ty * ROWS, qv);
      load_rows8(sdOt + d * TSTRIDE + ty * ROWS, dov);
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        kv[j] = sK[(tx + 16 * j) * (D + 1) + d];
        vv[j] = sV[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int ql = ty * ROWS + i;
      const int qpos = q0 + ql;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kl = tx + 16 * j;
        const int kpos = k0 + kl;
        float x = s[i][j] * p.scale;
        if (p.causal && kpos > qpos) x = NEG_INF;
        float pr = expf(x - row_lse[i]);
        if (qpos >= p.sq || kpos >= p.sk) pr = 0.f;
        const float ds = pr * (dp[i][j] - row_delta[i]) * p.scale;
        sdSt[kl * TSTRIDE + ql] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dQ += dS K for q rows ty*8+i, columns tx*DC+c
    const int k_hi = min(BK, p.sk - k0);
#pragma unroll 4
    for (int kk = 0; kk < k_hi; ++kk) {
      float dsv[ROWS], kv[DC];
      load_rows8(sdSt + kk * TSTRIDE + ty * ROWS, dsv);
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sK[kk * (D + 1) + tx * DC + c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty * ROWS + i;
    if (row < p.sq) {
#pragma unroll
      for (int c = 0; c < DC; ++c) dq[row * p.dq_ss + tx * DC + c] = from_f<T>(acc[i][c]);
    }
  }
}

enum class Which { kDkdv, kDq };

template <typename T, int D>
cudaError_t launch(Which which, const Params& p, int bh, cudaStream_t stream) {
  if (which == Which::kDkdv) {
    constexpr int smem = dkdv_smem_floats<D>() * static_cast<int>(sizeof(float));
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(bh, (p.sk + BK - 1) / BK);
    flash_bwd_dkdv_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  } else {
    constexpr int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(bh, (p.sq + BQ - 1) / BQ);
    flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(Which which, const Params& p, int head_dim, int bh,
                              cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(which, p, bh, stream);
    case 64: return launch<T, 64>(which, p, bh, stream);
    case 128: return launch<T, 128>(which, p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, const Params& p, int dtype, int head_dim, int batch, void* stream) {
  const int bh = batch * p.heads;
  if (bh == 0 || p.sq == 0 || p.sk == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch_head_dim<float>(which, p, head_dim, bh, st);
  } else if (dtype == 1) {
    e = dispatch_head_dim<__nv_bfloat16>(which, p, head_dim, bh, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

Params common(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, int heads, int sq, int sk,
              const long long* qs, const long long* ks, const long long* vs,
              const long long* dos, float scale, int causal) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.heads = heads; p.sq = sq; p.sk = sk;
  p.q_sb = qs[0]; p.q_ss = qs[1]; p.q_sh = qs[2];
  p.k_sb = ks[0]; p.k_ss = ks[1]; p.k_sh = ks[2];
  p.v_sb = vs[0]; p.v_ss = vs[1]; p.v_sh = vs[2];
  p.do_sb = dos[0]; p.do_ss = dos[1]; p.do_sh = dos[2];
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// q, dout: [batch, sq, heads, head_dim]; k, v: [batch, sk, heads, head_dim],
// each through its (batch, seq, head) element strides in `strides` (q, k, v,
// dout, then the outputs'), the last dim contiguous. lse, delta: [batch*heads,
// sq] f32 contiguous. dtype 0 = float32, 1 = bfloat16. Each returns
// cudaGetLastError() of its launch.

// dK, dV: [batch, sk, heads, head_dim] (strides[12..17]).
extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv, int dtype,
                                        int head_dim, int batch, int heads, int sq, int sk,
                                        const long long* strides, float scale, int causal,
                                        void* stream) {
  Params p = common(q, k, v, dout, lse, delta, heads, sq, sk, strides, strides + 3,
                    strides + 6, strides + 9, scale, causal);
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = strides[12]; p.dk_ss = strides[13]; p.dk_sh = strides[14];
  p.dv_sb = strides[15]; p.dv_ss = strides[16]; p.dv_sh = strides[17];
  return run(Which::kDkdv, p, dtype, head_dim, batch, stream);
}

// dQ: [batch, sq, heads, head_dim] (strides[12..14]).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int dtype, int head_dim, int batch,
                                      int heads, int sq, int sk, const long long* strides,
                                      float scale, int causal, void* stream) {
  Params p = common(q, k, v, dout, lse, delta, heads, sq, sk, strides, strides + 3,
                    strides + 6, strides + 9, scale, causal);
  p.dq = dq;
  p.dq_sb = strides[12]; p.dq_ss = strides[13]; p.dq_sh = strides[14];
  return run(Which::kDq, p, dtype, head_dim, batch, stream);
}
