// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` / `_fwd` (pl.pallas_call at line 114): online-softmax
// attention that never writes the [s, s] score matrix to device memory.
// Same results: s = (q . k) * scale in f32; causal masks kpos > qpos (top-left
// aligned) with the finite NEG_INF = -1e30 and skips kv tiles wholly above
// the diagonal; running max / sum in f32; p is rounded to the input dtype
// before P.V (the Pallas `p.astype(v.dtype)`); a row whose sum is 0 divides
// by 1 and gives 0; writes o in the input dtype and lse = m + log(l) as f32
// [b*h, sq] (no 128-lane broadcast).
//
// Blocking (not the TPU's): one CTA of 128 threads per (b*h, 64-row q tile);
// the TPU's sequential kv grid axis becomes a loop over 64-row kv tiles
// staged in shared memory. Thread (ty = tid/16, tx = tid%16) owns q rows
// ty*8..ty*8+7: for S it holds columns tx+16j (j < 4), so each row's max and
// sum reduce across the 16 lanes sharing ty with shuffles, and the row
// statistics m, l never leave registers; for O it holds columns
// tx*(D/16)..+D/16. Q and P are kept transposed in shared memory so a
// thread reads its 8 rows with two 16-byte loads. Inputs are read through
// their strides, so q, k, v may be the [b, s, h, d] views the model slices
// out of its fused qkv projection without a copy; only the last dim must be
// contiguous. Ragged sq and sk are masked.
//
// Bound at the slice shape (b=8, h=12, s=1024, d=64, causal):
//   work  = 2 * d * b*h * s*(s+1) ~ 12.9 GFLOP (the causal half)
//   bytes = q,k,v,o + lse: 50.7 MB in bf16, 101 MB in f32
//   bf16 on tensor cores: max(13 us at 989 TFLOP/s, 15 us at 3.35 TB/s)
//        = 15 us, bytes-bound.
//   f32 (the model's dtype on the main path): 12.9 GFLOP at the 67 TFLOP/s
//        of the FP32 units = 193 us, operations-bound.
// This first kernel does every product with FMA on the FP32 units (bf16 is
// widened to f32 in shared memory), so its floor is the 193 us in both
// dtypes. What the design does about the bound: S and P stay on chip, each
// K/V tile is read from device memory once per 64 q rows and reused from
// shared memory, the causal skip halves the work, and causal tiles are
// launched heaviest first. Tensor cores (mma.sync, then wgmma with TMA) are
// the next step toward the 15 us bf16 bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // q rows per CTA
constexpr int BK = 64;            // kv rows per tile
constexpr int NTHREADS = 128;
constexpr int ROWS = 8;           // q rows per thread
constexpr int COLS = 4;           // S columns per thread
constexpr int TSTRIDE = BQ + 4;   // row stride of transposed Q and P (16-byte aligned)
constexpr float NEG_INF = -1e30f;

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int heads, sq, sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// n consecutive floats of shared memory into registers, 16 bytes at a time
// where n allows it (the caller guarantees alignment).
template <int N>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + c);
      dst[c] = t.x; dst[c + 1] = t.y; dst[c + 2] = t.z; dst[c + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 2) {
      const float2 t = *reinterpret_cast<const float2*>(src + c);
      dst[c] = t.x; dst[c + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) dst[c] = src[c];
  }
}

__device__ __forceinline__ void load_rows8(const float* src, float (&dst)[ROWS]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

// reductions across the 16 lanes that share ty (xor offsets < 16 stay inside)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return D * TSTRIDE + BK * (D + 1) + BK * D + BK * TSTRIDE;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Params p) {
  constexpr int DC = D / 16;  // O columns per thread
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);  // [D][TSTRIDE]  Q transposed
  float* sK = sQt + D * TSTRIDE;                 // [BK][D + 1]   padded rows
  float* sV = sK + BK * (D + 1);                 // [BK][D]
  float* sPt = sV + BK * D;                      // [BK][TSTRIDE] P transposed

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
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const int qr = q0 + r;
    sQt[c * TSTRIDE + r] = qr < p.sq ? to_f(q[qr * p.q_ss + c]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
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
    __syncthreads();  // the previous tile's reads of sK, sV, sPt are done
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      const int kr = k0 + r;
      const bool ok = kr < p.sk;
      sK[r * (D + 1) + c] = ok ? to_f(k[kr * p.k_ss + c]) : 0.f;
      sV[r * D + c] = ok ? to_f(v[kr * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty*8+i, columns tx+16j
    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
      load_rows8(sQt + d * TSTRIDE + ty * ROWS, qv);
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = sK[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; masked entries take NEG_INF like the Pallas kernel,
    // columns past sk take -inf so they add exactly 0
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q0 + ty * ROWS + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.causal && kpos > qpos) x = NEG_INF;
        if (kpos >= p.sk) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        sPt[(tx + 16 * j) * TSTRIDE + ty * ROWS + i] = to_f(from_f<T>(e));
      }
      rs = half_warp_sum(rs);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V for rows ty*8+i, columns tx*DC+c
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[ROWS], vv[DC];
      load_rows8(sPt + kk * TSTRIDE + ty * ROWS, pv);
      load_row<DC>(sV + kk * D + tx * DC, vv);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty * ROWS + i;
    if (row < p.sq) {
      const float li = l[i] == 0.f ? 1.f : l[i];
      T* orow = o + row * p.o_ss + tx * DC;
#pragma unroll
      for (int c = 0; c < DC; ++c) orow[c] = from_f<T>(acc[i][c] / li);
      if (tx == 0) p.lse[static_cast<long long>(bh) * p.sq + row] = m[i] + logf(li);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (p.sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const Params& p, int head_dim, int bh, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, bh, stream);
    case 64: return launch<T, 64>(p, bh, stream);
    case 128: return launch<T, 128>(p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [batch, s, heads, head_dim] through the given element strides
// (batch, seq, head; the last dim contiguous). o likewise; lse [batch*heads, sq]
// f32 contiguous. dtype 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int dtype, int head_dim, int batch, int heads,
                                   int sq, int sk, long long q_sb, long long q_ss,
                                   long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss,
                                   long long v_sh, long long o_sb, long long o_ss,
                                   long long o_sh, float scale, int causal, void* stream) {
  const int bh = batch * heads;
  if (bh == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  if (sk == 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.heads = heads; p.sq = sq; p.sk = sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch_head_dim<float>(p, head_dim, bh, st);
  } else if (dtype == 1) {
    e = dispatch_head_dim<__nv_bfloat16>(p, head_dim, bh, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
