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
// Three kernels (flash_attention.py's forward_route picks by dtype):
// flash_fwd_mma_kernel (bf16) runs both products on the bf16 tensor cores;
// flash_fwd_tf32_kernel (f32) on the TF32 tensor cores, each product as three
// TF32 ones (3xTF32), which keeps f32 accuracy; flash_fwd_kernel does every
// product with FMA on the FP32 units, the predecessor of both, timed beside
// them at either dtype.
//
// Bound at the slice shape (b=8, h=12, s=1024, d=64, causal):
//   work  = 2 * d * b*h * s*(s+1) ~ 12.9 GFLOP (the causal half)
//   bytes = q,k,v,o + lse: 50.7 MB in bf16, 101 MB in f32
//   bf16 on tensor cores: max(13 us at 989 TFLOP/s, 15 us at 3.35 TB/s)
//        = 15 us, bytes-bound.
//   f32 (scoring's dtype): 12.9 GFLOP at the 67 TFLOP/s of the FP32 units
//        = 193 us, operations-bound; as three TF32 products (f32 accuracy
//        on the tensor cores), 38.7 GFLOP at 495 TFLOP/s = 78 us.
//
// FMA kernel. Blocking (not the TPU's): one CTA of 128 threads per (b*h,
// 64-row q tile); the TPU's sequential kv grid axis becomes a loop over
// 64-row kv tiles staged in shared memory. Thread (ty = tid/16, tx = tid%16)
// owns q rows ty*8..ty*8+7: for S it holds columns tx+16j (j < 4), so each
// row's max and sum reduce across the 16 lanes sharing ty with shuffles, and
// the row statistics m, l never leave registers; for O it holds columns
// tx*(D/16)..+D/16. Q and P are kept transposed in shared memory so a
// thread reads its 8 rows with two 16-byte loads. Inputs are read through
// their strides, so q, k, v may be the [b, s, h, d] views the model slices
// out of its fused qkv projection without a copy; only the last dim must be
// contiguous. Ragged sq and sk are masked. Its floor is the 193 us of the
// FP32 units in both dtypes; S and P stay on chip, each K/V tile is read
// once per 64 q rows, the causal skip halves the work, and causal tiles are
// launched heaviest first.
//
// Tensor-core kernel (FA2 on mma.sync.m16n8k16, the fragments of
// mma_sync.cuh). The same CTA grid and causal order; 4 warps, each owning 16
// of the 64 q rows, so every row statistic lives in one warp.
//   - The Q tile is copied once into shared memory and from there into
//     registers as A fragments (D/16 k steps), where it stays.
//   - K and V tiles of 64 rows come through a cp.async double buffer: tile
//     t + 1 is in flight while tile t computes. Rows past sk are zero-filled
//     through cp.async's src-size; their columns are masked by index. Rows
//     are padded by 16 bytes, so the 8 rows of an ldmatrix fall in distinct
//     banks.
//   - S = Q . K^T: K through plain ldmatrix (d is contiguous in K's rows).
//     The warp's S is 16 x 64 f32 in registers; a thread holds rows gq and
//     gq + 8. The scale is folded into log2 units (exp2 on the MUFU); the
//     row max is two quad shuffles; the row sum stays a per-thread partial
//     until the end (the quad shares the max, so partials rescale alike).
//   - Only the tiles that cross the diagonal (or the ragged sk edge) pay
//     for the mask.
//   - P goes from the S accumulators straight into bf16 A fragments (no
//     shared-memory round trip); O += P . V reads V with ldmatrix.trans.
//   - O is staged through the warp's own rows of the Q tile, so each row
//     leaves in 16-byte stores.
// Operands are read through their strides like the FMA kernel's, but
// cp.async needs 16-byte aligned rows: the wrapper hands over a contiguous
// copy of a view that is not (flash_attention.py `_mma_operand`).
// Registers: Q fragments D/8, S 32, O D/2 floats a thread. Shared memory
// (64 + 4 * 64) rows of D + 8 bf16: 46 KB at d = 64, 87 KB at d = 128.
//
// 3xTF32 kernel (mma.sync.m16n8k8 .tf32 with mma_sync.cuh's split_tf32,
// mma_tf32x3, tf32_product and store_rows_f32, as the f32 backward pair in
// flash_attention_bwd.cu). The bf16 kernel's grid, causal order, 4 warps of
// 16 q rows and cp.async double buffer of K and V, on f32 tiles of 64 rows
// of D + 4 floats (16 bytes of pad: the 8 rows of an ldmatrix fall in
// distinct banks): 46 KB at d = 32, 87 KB at d = 64, 169 KB at d = 128.
//   - S = Q K^T: Q and K both [rows][k], through ldmatrix (an f32 tile's
//     8 x 4 blocks are ldmatrix's 8 x 8 b16 blocks), each value split into
//     a TF32 big and small part where it is loaded. The warp's Q rows are
//     reloaded and split each tile: kept in registers, split Q takes D
//     registers a thread, which measured slower at every d (at d 32 two
//     CTAs an SM fit their registers, not three; 18% at d 128). S sums at
//     most 16 k8 steps and keeps one accumulator.
//   - Online softmax in natural units: the row max of s * scale over the
//     quad; p = exp2(fma(s, scale, -m) * log2e) on the MUFU, the argument
//     rounded once, as expf's is in the FMA kernel. Only diagonal and
//     ragged tiles pay for the mask, and a masked entry gets p = 0 by index
//     (the Pallas kernel's exp(NEG_INF - m): every row sees key 0 in its
//     first tile, so m is finite from then on).
//   - O += P V in passes of 32 kv rows (8 at d = 128): P goes from S's C
//     fragments straight into split A fragments (a_slot's k order: A's k
//     slot tq is the C fragment's column 2tq), and V, k-major, which
//     ldmatrix cannot transpose at 32 bits, takes scalar loads in the same
//     k order (tf32_product). The tensor core truncates as it accumulates
//     and O sums up to sk rows, so each pass goes into a fresh accumulator,
//     added in f32 after O's rescale by the tile's alpha.
//   - o = O / l leaves as float2 stores from the C fragments; lse = m +
//     log(l).
// Registers: S 32, O D/2 and the pass's split P 32 (8 at d = 128) floats a
// thread; at d = 128 S's loop over d is unrolled by 4, not in full, and 255
// registers hold it all with no spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

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

// ------------------------------------------------ tensor-core kernel (bf16)

template <int D>
constexpr int mma_smem_bytes() {
  return (BQ + 4 * BK) * (D + mma_sync::MPAD) * 2;  // Q, then two K and two V tiles
}

// The launch bounds name a minimum of one CTA an SM: with the maximum
// thread count alone, ptxas held the d = 32 instance to 96 registers and
// spilled 16 bytes; with the minimum, it takes 124 and spills none.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_fwd_mma_kernel(const Params p) {
  using namespace mma_sync;
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + MPAD;  // row stride (bf16) of the staged tiles
  constexpr int KS = D / 16;    // k steps of S = Q K^T
  constexpr int NO = D / 8;     // n8 tiles of O
  constexpr int VEC = D / 8;    // 16-byte pieces a row
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);  // [BQ][LD]
  bf16* sK = sQ + BQ * LD;                    // 2 x [BK][LD]
  bf16* sV = sK + 2 * BK * LD;                // 2 x [BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int w0 = q0 + warp * 16;                     // this warp's first q row

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // rows r0.. of a [rows, D] operand with row stride ss -> dst [64][LD],
  // asynchronously; rows past `rows` as zeros
  auto stage = [&](bf16* dst, const bf16* src, long long ss, int r0, int rows) {
    stage_rows<64, NTHREADS>(dst, LD, src, ss, VEC, r0, rows);
  };

  int n_kv = (p.sk + BK - 1) / BK;
  if (p.causal) {
    const int last_q = min(q0 + BQ, p.sq) - 1;
    n_kv = min(n_kv, last_q / BK + 1);
  }
  stage(sQ, q, p.q_ss, q0, p.sq);
  cp_async_commit();
  stage(sK, k, p.k_ss, 0, p.sk);
  stage(sV, v, p.v_ss, 0, p.sk);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed (tile 0 may still be in flight)
  __syncthreads();
  unsigned qf[KS][4];
  {
    const unsigned a = smem_u32(sQ + warp * 16 * LD + a_lane(lane, LD));
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldsm_x4(a + ks * 32, qf[ks]);
  }

  // ldmatrix lane offsets (bytes) inside a K or V tile
  const unsigned k_lane = b_lane(lane, LD) * 2;
  const unsigned v_lane = bt_lane(lane, LD) * 2;
  const float scale2 = p.scale * LOG2E;  // s in log2 units: exp(s - m) = exp2(s2 - m2)

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows gq, gq + 8 (log2 units)
  float l[2] = {0.f, 0.f};          // this thread's partial sums

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();  // tile kt has landed ...
    __syncthreads();     // ... for every thread; tile kt - 1's buffers are free
    if (kt + 1 < n_kv) {
      stage(sK + ((kt + 1) & 1) * BK * LD, k, p.k_ss, k0 + BK, p.sk);
      stage(sV + ((kt + 1) & 1) * BK * LD, v, p.v_ss, k0 + BK, p.sk);
      cp_async_commit();
    }
    const unsigned kb = smem_u32(sK + (kt & 1) * BK * LD) + k_lane;
    const unsigned vb = smem_u32(sV + (kt & 1) * BK * LD) + v_lane;

    // S[16 q rows, 64 kv columns] = Q K^T
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bk[4];
        ldsm_x4(kb + (np * 16 * LD + ks * 16) * 2, bk);
        mma_bf16(s[2 * np], qf[ks], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }

    // scale (log2 units) and, on the diagonal or ragged tiles, mask
    const bool masked = (p.causal && k0 + BK - 1 > w0) || k0 + BK > p.sk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (masked) {
          const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
          const int qpos = w0 + gq + (e >> 1) * 8;
          if (p.causal && kpos > qpos) x = NEG_INF;
          if (kpos >= p.sk) x = -INFINITY;  // not a column: adds exactly 0
        }
        s[j][e] = x;
      }

    // online softmax: the row max over the quad, rescale, p from unrounded s
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = exp2_approx(m[i] - mx);
      m[i] = mx;
    }
    unsigned pf[4][4];  // P as bf16 A fragments, one per 16 kv columns
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2_approx(s[j][0] - m[0]), p1 = exp2_approx(s[j][1] - m[0]);
      const float p2 = exp2_approx(s[j][2] - m[1]), p3 = exp2_approx(s[j][3] - m[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O[16, D] += P[16, 64] V[64, D]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned bv[4];
        ldsm_x4_t(vb + (kk * 16 * LD + dp * 16) * 2, bv);
        mma_bf16(oacc[2 * dp], pf[kk], bv[0], bv[1]);
        mma_bf16(oacc[2 * dp + 1], pf[kk], bv[2], bv[3]);
      }
    }
  }

  // the row sums over the quad; o = acc / l (l = 0 divides by 1), as a
  // product with the MUFU reciprocal: l is in [1, sk], and an IEEE division
  // would call a slow-path subroutine that spills registers around it
  float li[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t = l[i];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    li[i] = t == 0.f ? 1.f : t;
    inv[i] = __fdividef(1.f, li[i]);
  }
  // o in bf16 out through this warp's own rows of the Q tile (no other warp
  // reads them)
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] *= inv[e >> 1];
  store_rows<D>(oacc, sQ + warp * 16 * LD, LD, o, p.o_ss, w0, p.sq);
  if (tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = w0 + gq + 8 * i;
      if (row < p.sq)
        p.lse[static_cast<long long>(bh) * p.sq + row] = m[i] * LN2 + logf(li[i]);
    }
  }
}

template <int D>
cudaError_t launch_mma(const Params& p, int bh, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (p.sq + BQ - 1) / BQ);
  flash_fwd_mma_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// --------------------------------------------------- 3xTF32 kernel (f32)

// kv rows a P . V pass (PV / 8 k8 steps): 32, and 8 at d = 128, where O
// alone takes 64 registers; there the k8 steps of S are unrolled by 4, not
// all 16. Passes of 16 or 32 rows, or S unrolled in full, spilled at d =
// 128 (PERF.md).
template <int D>
constexpr int TF32_PV = D <= 64 ? 32 : 8;

template <int D>
constexpr int tf32_smem_bytes() {
  return (BQ + 4 * BK) * (D + mma_sync::FPAD) * 4;  // Q, then two K and two V tiles
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_fwd_tf32_kernel(const Params p) {
  using namespace mma_sync;
  constexpr int LD = D + FPAD;  // row stride (f32) of the staged tiles
  constexpr int KS = D / 8;     // k8 steps of S = Q K^T
  constexpr int PV = TF32_PV<D>;
  constexpr int SU = D <= 64 ? KS : 4;  // k8 steps of S unrolled
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* sK = sQ + BQ * LD;                     // 2 x [BK][LD]
  float* sV = sK + 2 * BK * LD;                 // 2 x [BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int w0 = q0 + warp * 16;                     // this warp's first q row

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  // rows r0.. of a [rows, D] operand with row stride ss -> dst [64][LD],
  // asynchronously; rows past `rows` as zeros
  auto stage = [&](float* dst, const float* src, long long ss, int r0, int rows) {
    stage_rows<64, NTHREADS>(dst, LD, src, ss, D / 4, r0, rows);
  };

  int n_kv = (p.sk + BK - 1) / BK;
  if (p.causal) {
    const int last_q = min(q0 + BQ, p.sq) - 1;
    n_kv = min(n_kv, last_q / BK + 1);
  }
  stage(sQ, q, p.q_ss, q0, p.sq);
  cp_async_commit();
  stage(sK, k, p.k_ss, 0, p.sk);
  stage(sV, v, p.v_ss, 0, p.sk);
  cp_async_commit();

  // ldmatrix lane address of the warp's Q rows (A fragments), reloaded and
  // split each tile: kept in registers, split Q takes D registers, and that
  // measured slower at every d (PERF.md)
  const unsigned qa = smem_u32(sQ + warp * 16 * LD + a_lane(lane, LD, 4));
  const unsigned k_lane = b_lane(lane, LD, 4) * 4;  // ldmatrix lane offset (bytes) in K
  Tf32Acc<D> oacc = {};
  float m[2] = {NEG_INF, NEG_INF};  // rows gq, gq + 8: max of s * scale
  float l[2] = {0.f, 0.f};          // this thread's partial sums

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();  // tile kt has landed ...
    __syncthreads();     // ... for every thread; tile kt - 1's buffers are free
    if (kt + 1 < n_kv) {
      stage(sK + ((kt + 1) & 1) * BK * LD, k, p.k_ss, k0 + BK, p.sk);
      stage(sV + ((kt + 1) & 1) * BK * LD, v, p.v_ss, k0 + BK, p.sk);
      cp_async_commit();
    }
    const unsigned kb = smem_u32(sK + (kt & 1) * BK * LD) + k_lane;
    const float* tV = sV + (kt & 1) * BK * LD;

    // S[16 q rows, 64 kv columns] = Q K^T in 3xTF32
    float s[1][8][4] = {};
#pragma unroll (SU)
    for (int ks = 0; ks < KS; ++ks) {
      unsigned qr[4], ab[1][4], as[1][4], bb[8][2], bs[8][2];
      ldsm_x4(qa + ks * 32, qr);
#pragma unroll
      for (int x = 0; x < 4; ++x) split_tf32(qr[x], ab[0][x], as[0][x]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned r[4];
        ldsm_x4(kb + (np * 16 * LD + ks * 8) * 4, r);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split_tf32(r[x], bb[2 * np + (x >> 1)][x & 1], bs[2 * np + (x >> 1)][x & 1]);
      }
      mma_tf32x3(s, ab, as, bb, bs);
    }

    // the row max of s * scale over the quad, with the mask on the diagonal
    // and ragged tiles (bit 4j + e of `dead`: entry (j, e) masked)
    const bool masked = (p.causal && k0 + BK - 1 > w0) || k0 + BK > p.sk;
    unsigned dead = 0;
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * i + c;
          float x = s[0][j][e] * p.scale;
          if (masked) {
            const int kpos = k0 + j * 8 + 2 * tq + c;
            const int qpos = w0 + gq + 8 * i;
            const bool above = p.causal && kpos > qpos, edge = kpos >= p.sk;
            if (above) x = NEG_INF;
            if (edge) x = -INFINITY;  // not a column
            if (above || edge) dead |= 1u << (4 * j + e);
          }
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = exp2_approx((m[i] - mx) * LOG2E);
      m[i] = mx;
    }
#pragma unroll
    for (int g = 0; g < D / (8 * TF32_GROUP<D>); ++g)
#pragma unroll
      for (int j = 0; j < TF32_GROUP<D>; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[g][0][j][e] *= alpha[e >> 1];

    // O[16, D] += P[16, 64] V[64, D], a pass of PV kv rows at a time
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += PV) {
      unsigned pb[PV / 8][1][4], ps[PV / 8][1][4];
#pragma unroll
      for (int jj = 0; jj < PV / 8; ++jj) {
        const int j = c0 / 8 + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = exp2_approx(fmaf(s[0][j][e], p.scale, -m[e >> 1]) * LOG2E);
          if ((dead >> (4 * j + e)) & 1u) pe = 0.f;
          rs[e >> 1] += pe;
          split_tf32(__float_as_uint(pe), pb[jj][0][a_slot(e)], ps[jj][0][a_slot(e)]);
        }
      }
      tf32_product<D, PV / 8>(oacc, pb, ps, tV + c0 * LD);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
  }

  // the row sums over the quad; o = O / l (l = 0 divides by 1) as a product
  // with the MUFU reciprocal (an IEEE division calls a slow-path subroutine)
  float li[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t = l[i];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    li[i] = t == 0.f ? 1.f : t;
    inv[i] = __fdividef(1.f, li[i]);
  }
#pragma unroll
  for (int g = 0; g < D / (8 * TF32_GROUP<D>); ++g)
#pragma unroll
    for (int j = 0; j < TF32_GROUP<D>; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[g][0][j][e] *= inv[e >> 1];
  store_rows_f32<D>(oacc, o, p.o_ss, w0, p.sq);
  if (tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = w0 + gq + 8 * i;
      if (row < p.sq) p.lse[static_cast<long long>(bh) * p.sq + row] = m[i] + logf(li[i]);
    }
  }
}

template <int D>
cudaError_t launch_tf32(const Params& p, int bh, cudaStream_t stream) {
  constexpr int smem = tf32_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_tf32_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (p.sq + BQ - 1) / BQ);
  flash_fwd_tf32_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, void* o, void* lse,
                   int heads, int sq, int sk, long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                   long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                   long long o_sh, float scale, int causal) {
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
  return p;
}

// The tensor-core kernels, bf16 (f32 = false) or 3xTF32 (f32 = true): every
// operand 16-byte aligned, with batch, seq and head strides multiples of 8
// bf16 or 4 f32 elements (cp.async copies 16-byte pieces); else
// cudaErrorInvalidValue, as for a head dim without an instance.
int run_tc(const Params& p, bool f32, int head_dim, int batch, void* stream) {
  const int bh = batch * p.heads;
  if (bh == 0 || p.sq == 0) return static_cast<int>(cudaSuccess);
  using mma_sync::aligned16;
  const int vec = f32 ? 4 : 8;
  if (p.sk == 0 || !aligned16(p.q, {p.q_sb, p.q_ss, p.q_sh}, vec) ||
      !aligned16(p.k, {p.k_sb, p.k_ss, p.k_sh}, vec) ||
      !aligned16(p.v, {p.v_sb, p.v_ss, p.v_sh}, vec) ||
      !aligned16(p.o, {p.o_sb, p.o_ss, p.o_sh}, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return static_cast<int>(f32 ? launch_tf32<32>(p, bh, st) : launch_mma<32>(p, bh, st));
    case 64: return static_cast<int>(f32 ? launch_tf32<64>(p, bh, st) : launch_mma<64>(p, bh, st));
    case 128:
      return static_cast<int>(f32 ? launch_tf32<128>(p, bh, st) : launch_mma<128>(p, bh, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
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
  const Params p = make_params(q, k, v, o, lse, heads, sq, sk, q_sb, q_ss, q_sh, k_sb, k_ss,
                               k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal);
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

// The tensor-core forwards: q, k, v, o as flash_attention_fwd takes them,
// bf16 for _mma and f32 for _tf32, with every pointer 16-byte aligned and
// every batch, seq and head stride a multiple of 8 bf16 or 4 f32 elements
// (cp.async copies 16-byte pieces). Return cudaGetLastError(), or
// cudaErrorInvalidValue for a head dim without an instance or an operand
// that is not aligned so.
extern "C" int flash_attention_fwd_mma(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int head_dim, int batch, int heads, int sq,
                                       int sk, long long q_sb, long long q_ss, long long q_sh,
                                       long long k_sb, long long k_ss, long long k_sh,
                                       long long v_sb, long long v_ss, long long v_sh,
                                       long long o_sb, long long o_ss, long long o_sh,
                                       float scale, int causal, void* stream) {
  return run_tc(make_params(q, k, v, o, lse, heads, sq, sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal),
                false, head_dim, batch, stream);
}

extern "C" int flash_attention_fwd_tf32(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int head_dim, int batch, int heads, int sq,
                                        int sk, long long q_sb, long long q_ss, long long q_sh,
                                        long long k_sb, long long k_ss, long long k_sh,
                                        long long v_sb, long long v_ss, long long v_sh,
                                        long long o_sb, long long o_ss, long long o_sh,
                                        float scale, int causal, void* stream) {
  return run_tc(make_params(q, k, v, o, lse, heads, sq, sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal),
                true, head_dim, batch, stream);
}
