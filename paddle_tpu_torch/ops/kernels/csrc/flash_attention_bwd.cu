// Flash-attention backward for Hopper (sm_90a), CUDA C++: the FA2 dK/dV and
// dQ kernels, on the FP32 units, on the bf16 tensor cores (bf16) and on the
// TF32 tensor cores in 3xTF32 (f32).
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
// Inputs are read through their strides (the model's q, k, v are views of
// one fused projection); only the last dim must be contiguous. Ragged sq and
// sk are masked.
//
// Bound at the training shape (b=8, h=12, s=1024, d=64, causal): the FA2
// backward needs 5 products of 2*d*b*h*s*(s+1)/2 = 6.45 GFLOP each (S, dP,
// dV, dK, dQ: 32.2 GFLOP); split into two kernels, dkdv does 4 (25.8 GFLOP)
// and dq 3 (19.3 GFLOP), since each recomputes S and dP. On the FP32 units
// (67 TFLOP/s, no TF32) that is 0.385 ms for dkdv and 0.289 ms for dq; in
// bf16 on tensor cores (989 TFLOP/s) 26 and 20 us, just above the bytes each
// must move (76 and 64 MB: 23 and 19 us at 3.35 TB/s); in f32 as three TF32
// products each (495 TFLOP/s) 0.156 and 0.117 ms.
//
// Three kernels for each function, picked by dtype (flash_attention.py's
// backward_route): flash_bwd_{dkdv,dq}_kernel do every product with FMA on
// the FP32 units (the predecessors, timed beside the others);
// flash_bwd_{dkdv,dq}_mma_kernel (bf16) run every product on the bf16
// tensor cores; flash_bwd_{dkdv,dq}_tf32_kernel (f32) on the TF32 tensor
// cores, each product as three (3xTF32), which keeps f32 accuracy.
//
// FMA kernels. Thread (ty = tid/16, tx = tid%16) of 128 owns 8 rows of the
// CTA's own tile (kv rows for dkdv, q rows for dq) and, for the S and dP
// tiles, the 4 columns tx+16j of the other side; the operand of its own
// side is staged transposed in shared memory (bf16 widened to f32) so its 8
// rows load as two 16-byte words. P and dS go through shared memory once,
// laid out so the accumulating products read 8 consecutive rows the same
// way. Their floor is the f32 one in both dtypes. Each CTA reads its own
// tile from device memory once and the other side's tiles once each per
// loop step; S, P, dP and dS never leave the chip; the causal skip halves
// the work; causal CTAs with the most work are launched first.
//
// Tensor-core kernels (mma.sync.m16n8k16 bf16 with f32 accumulation, the
// fragments of mma_sync.cuh). The same grids, splits and causal order; 4
// warps, each owning 16 rows of the CTA's 64. Nothing of P or dS goes
// through shared memory: each is repacked from the f32 accumulators into
// bf16 A fragments (rounded there, where the reference rounds).
//   - dkdv: the warp computes the transposed tiles S^T = K_w Q^T and dP^T =
//     V_w dO^T with its K and V rows as A fragments (kept in registers for
//     d <= 64, reloaded from the staged tile each pass at d = 128), Q and
//     dO as B through plain ldmatrix ([q][d] is [n][k]). lse and delta are
//     per column there: staged with each q tile and read as (2tq, 2tq + 1)
//     pairs. P^T and dS^T become A fragments (kv x q, q the k dim) and dV
//     += P^T dO, dK += dS^T Q read dO and Q through ldmatrix.trans. Q, dO,
//     lse and delta come through a cp.async double buffer: the next q tile
//     is in flight while this one computes. At d = 128 a q tile is taken in
//     two passes of 32 columns, so S^T and dP^T take 32 registers, not 64,
//     beside the 128 of the dK and dV accumulators.
//   - dq: the forward's structure with dP added. Q and dO are A fragments
//     (in registers for d <= 64, reloaded from the staged tile at d = 128),
//     lse and delta per row in registers; K and V tiles come through a
//     cp.async double buffer; S = Q K^T and dP = dO V^T read K and V through
//     plain ldmatrix; dS becomes A fragments and dQ += dS K reads K through
//     ldmatrix.trans.
//   - The scale is folded into log2 units, P = exp2(S scale log2e - lse
//     log2e) on the MUFU, as in the forward. Only warps whose tile crosses
//     the diagonal or a ragged edge pay for the mask, and the mask sets P =
//     0 by index: a zero-filled q row has lse = 0 and would give exp(0) = 1.
//   - Staged rows carry a 16-byte pad, so the 8 rows of an ldmatrix fall in
//     distinct banks; rows past sq or sk are zero-filled by cp.async's
//     src-size. dK, dV and dQ leave through the warp's own rows of a staged
//     tile in 16-byte stores.
// Operands are read through their strides, but cp.async needs 16-byte
// aligned rows: the wrapper hands over a contiguous copy of a view that is
// not (flash_attention.py `_mma_operand`). Shared memory: six tiles of 64
// rows of d + 8 bf16 (55 KB at d = 64, 104 KB at d = 128), and for dkdv two
// 64-float lse and delta rows.
//
// 3xTF32 kernels (mma.sync.m16n8k8 .tf32, the TF32 fragments and split_tf32
// of mma_sync.cuh, and the accumulator, product and epilogue they share
// there with the f32 forward). The bf16 pair's grids, splits, causal
// order, warps and cp.async double buffers, on f32 tiles of 64 rows of d +
// 4 floats (105 KB at d = 64, 204 KB at d = 128). Each f32 value is split
// into a TF32 big and small part where it is loaded, and each product is
// a_small b_big + a_big b_small + a_big b_big: one TF32 pass errs by ~2^-11
// of a product.
//   - The other side's tile is taken in passes of 32 rows (16 at d = 128),
//     so that the pass's S and dP tiles and the split P and dS fragments fit
//     in registers beside dK and dV (dQ). S and dP read both operands
//     through ldmatrix (an f32 [m][k] or [n][k] tile's 8 x 4 blocks are
//     ldmatrix's 8 x 8 b16 blocks).
//   - P and dS go from C fragments straight into A fragments with no
//     shuffle: a C fragment holds columns 2tq and 2tq + 1 where an A
//     fragment wants k tq and tq + 4, so k slot tq is read as column 2tq and
//     slot tq + 4 as column 2tq + 1, and the accumulating products' B (dO
//     and Q in dkdv, K in dq: k-major, which ldmatrix cannot transpose at 32
//     bits) takes scalar loads in the same k order. Each P and dS value is
//     split once.
//   - The tensor core truncates as it accumulates, and dK, dV, dQ sum up to
//     sq or sk rows: each pass is summed in a fresh accumulator and added in
//     f32 (mma_sync.cuh add_frags). S and dP sum at most 16 k8 steps and
//     keep one accumulator.
//   - exp as exp2(fma(s, scale, -lse) * log2e) on the MUFU: the argument
//     rounds once, as expf's does in the FMA kernels. Masked entries get P =
//     0 by index.
//   - Outputs leave as float2 stores from the C fragments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace {

constexpr int BQ = 64;            // q rows per tile
constexpr int BK = 64;            // kv rows per tile
constexpr int NTHREADS = 128;
constexpr int ROWS = 8;           // own-tile rows per thread
constexpr int COLS = 4;           // S / dP columns per thread
constexpr int TSTRIDE = 64 + 4;   // row stride of transposed tiles (16-byte aligned)
constexpr float NEG_INF = -1e30f;
static_assert(BQ == 64 && BK == 64 && NTHREADS == 128,
              "the thread layouts cover 64 x 64 tiles with 128 threads");

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

// ----------------------------------------------- tensor-core kernels (bf16)

using mma_sync::MPAD;

template <int D>
constexpr int dkdv_mma_smem_bytes() {
  // K, V, two Q and two dO tiles; two [lse 64 | delta 64] rows
  return 6 * 64 * (D + MPAD) * 2 + 2 * 128 * 4;
}

template <int D>
constexpr int dq_mma_smem_bytes() {
  return 6 * 64 * (D + MPAD) * 2;  // Q, dO, two K and two V tiles
}

// rows r0.. of a [rows, D] bf16 or f32 operand with row stride ss -> dst
// [64][D + 16 bytes] (D + MPAD bf16, D + FPAD f32), asynchronously; rows past
// `rows` as zeros
template <int D, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ss, int r0,
                                           int rows) {
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  mma_sync::stage_rows<64, NTHREADS>(dst, D + V, src, ss, D / V, r0, rows);
}

// lse and delta of q rows q0..q0+63 -> dst[0..63], dst[64..127] (one float a
// thread), asynchronously; rows past sq as zeros
__device__ __forceinline__ void stage_row_stats(float* dst, const float* lse,
                                                const float* delta, int q0, int sq) {
  const int t = threadIdx.x, r = t & 63;
  const bool ok = q0 + r < sq;
  mma_sync::cp_async4(mma_sync::smem_u32(dst + t), (t < 64 ? lse : delta) + (ok ? q0 + r : 0),
                      ok ? 4 : 0);
}

// The launch bounds name a minimum of one CTA an SM, as the forward's do:
// with the thread count alone a ptxas heuristic caps the registers and
// spills (flash_attention_fwd.cu).
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dkdv_mma_kernel(const Params p) {
  using namespace mma_sync;
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + MPAD;
  constexpr int KS = D / 16;               // k steps of S^T and dP^T (over d)
  constexpr int NO = D / 8;                // n8 tiles of dK and dV
  constexpr bool RESIDENT = D <= 64;       // K_w, V_w fragments stay in registers
  constexpr int QC = RESIDENT ? BQ : 32;   // q columns a pass
  constexpr int NJ = QC / 8;               // n8 tiles of S^T a pass
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);                    // [BK][LD]
  bf16* sV = sK + BK * LD;                                      // [BK][LD]
  bf16* sQ = sV + BK * LD;                                      // 2 x [BQ][LD]
  bf16* sdO = sQ + 2 * BQ * LD;                                 // 2 x [BQ][LD]
  float* sStat = reinterpret_cast<float*>(sdO + 2 * BQ * LD);   // 2 x [lse | delta]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * BK;  // causal: the first kv tiles see the most q tiles
  const int w0 = k0 + warp * 16;   // this warp's first kv row

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.sq;

  // causal: q tiles that end before this kv tile starts see none of it
  const int n_q = (p.sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? k0 / BQ : 0;
  stage_tile<D>(sK, k, p.k_ss, k0, p.sk);
  stage_tile<D>(sV, v, p.v_ss, k0, p.sk);
  if (qt0 < n_q) {
    stage_tile<D>(sQ, q, p.q_ss, qt0 * BQ, p.sq);
    stage_tile<D>(sdO, dout, p.do_ss, qt0 * BQ, p.sq);
    stage_row_stats(sStat, lse, delta, qt0 * BQ, p.sq);
  }
  cp_async_commit();

  const unsigned kA = smem_u32(sK + warp * 16 * LD + a_lane(lane, LD));
  const unsigned vA = smem_u32(sV + warp * 16 * LD + a_lane(lane, LD));
  const unsigned bl = b_lane(lane, LD) * 2, btl = bt_lane(lane, LD) * 2;
  unsigned kf[RESIDENT ? KS : 1][4], vf[RESIDENT ? KS : 1][4];
  if constexpr (RESIDENT) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldsm_x4(kA + ks * 32, kf[ks]);
      ldsm_x4(vA + ks * 32, vf[ks]);
    }
  }
  const float scale2 = p.scale * LOG2E;  // exp(s scale - lse) = exp2(s scale2 - lse log2e)

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    const int buf = (qt - qt0) & 1;
    cp_async_wait<0>();  // q tile qt has landed ...
    __syncthreads();     // ... for every thread; tile qt - 1's buffers are free
    if (qt + 1 < n_q) {
      stage_tile<D>(sQ + (buf ^ 1) * BQ * LD, q, p.q_ss, q0 + BQ, p.sq);
      stage_tile<D>(sdO + (buf ^ 1) * BQ * LD, dout, p.do_ss, q0 + BQ, p.sq);
      stage_row_stats(sStat + (buf ^ 1) * 128, lse, delta, q0 + BQ, p.sq);
      cp_async_commit();
    }
    const unsigned qb = smem_u32(sQ + buf * BQ * LD);
    const unsigned dob = smem_u32(sdO + buf * BQ * LD);
    const float* st = sStat + buf * 128;
    const bool masked = (p.causal && w0 + 15 > q0) || q0 + BQ > p.sq || w0 + 16 > p.sk;

#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += QC) {
      // S^T = K_w Q^T and dP^T = V_w dO^T: [16 kv rows, QC q columns]
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned ka[4], va[4];
        if constexpr (RESIDENT) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[ks][e];
            va[e] = vf[ks][e];
          }
        } else {
          ldsm_x4(kA + ks * 32, ka);
          ldsm_x4(vA + ks * 32, va);
        }
#pragma unroll
        for (int np = 0; np < NJ / 2; ++np) {
          const unsigned off = bl + ((c0 + np * 16) * LD + ks * 16) * 2;
          unsigned bq[4], bd[4];
          ldsm_x4(qb + off, bq);
          mma_bf16(s[2 * np], ka, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
          ldsm_x4(dob + off, bd);
          mma_bf16(dp[2 * np], va, bd[0], bd[1]);
          mma_bf16(dp[2 * np + 1], va, bd[2], bd[3]);
        }
      }

      // P^T = exp2(S^T scale2 - lse log2e) and dS^T = P^T (dP^T - delta)
      // scale, with lse and delta those of the columns (q rows); straight
      // into bf16 A fragments (kv x q, q the k dim)
      unsigned pf[QC / 16][4], dsf[QC / 16][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = c0 + j * 8 + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(st + col);
        const float2 d2 = *reinterpret_cast<const float2*>(st + 64 + col);
        float pr[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = (e & 1) ? l2.y : l2.x;
          const float delta_c = (e & 1) ? d2.y : d2.x;
          float pe = exp2_approx(s[j][e] * scale2 - lse_c * LOG2E);
          if (masked) {
            const int qpos = q0 + col + (e & 1);
            const int kpos = w0 + gq + (e >> 1) * 8;
            if ((p.causal && kpos > qpos) || qpos >= p.sq || kpos >= p.sk) pe = 0.f;
          }
          pr[e] = pe;
          ds[e] = pe * (dp[j][e] - delta_c) * p.scale;
        }
        pf[j >> 1][(j & 1) * 2] = pack_bf16(pr[0], pr[1]);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pr[2], pr[3]);
        dsf[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q over the pass's QC q rows
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          const unsigned off = btl + ((c0 + kk * 16) * LD + dn * 16) * 2;
          unsigned bo[4], bq[4];
          ldsm_x4_t(dob + off, bo);
          mma_bf16(dv[2 * dn], pf[kk], bo[0], bo[1]);
          mma_bf16(dv[2 * dn + 1], pf[kk], bo[2], bo[3]);
          ldsm_x4_t(qb + off, bq);
          mma_bf16(dk[2 * dn], dsf[kk], bq[0], bq[1]);
          mma_bf16(dk[2 * dn + 1], dsf[kk], bq[2], bq[3]);
        }
      }
    }
  }

  // a causal kv tile past sq ran no q tile: its K and V copies (made by every
  // thread, into every warp's rows) must land before the rows are reused
  cp_async_wait<0>();
  __syncthreads();
  bf16* dk_out = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dv_out = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<D>(dk, sK + warp * 16 * LD, LD, dk_out, p.dk_ss, w0, p.sk);
  store_rows<D>(dv, sV + warp * 16 * LD, LD, dv_out, p.dv_ss, w0, p.sk);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dq_mma_kernel(const Params p) {
  using namespace mma_sync;
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + MPAD;
  constexpr int KS = D / 16;           // k steps of S and dP (over d)
  constexpr int NO = D / 8;            // n8 tiles of dQ
  constexpr bool RESIDENT = D <= 64;   // Q, dO fragments stay in registers
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);  // [BQ][LD]
  bf16* sdO = sQ + BQ * LD;                   // [BQ][LD]
  bf16* sK = sdO + BQ * LD;                   // 2 x [BK][LD]
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
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.sq;

  // causal: kv tiles starting past this tile's last query row contribute nothing
  int n_kv = (p.sk + BK - 1) / BK;
  if (p.causal) {
    const int last_q = min(q0 + BQ, p.sq) - 1;
    n_kv = min(n_kv, last_q / BK + 1);
  }
  stage_tile<D>(sQ, q, p.q_ss, q0, p.sq);
  stage_tile<D>(sdO, dout, p.do_ss, q0, p.sq);
  cp_async_commit();
  stage_tile<D>(sK, k, p.k_ss, 0, p.sk);
  stage_tile<D>(sV, v, p.v_ss, 0, p.sk);
  cp_async_commit();

  const unsigned qA = smem_u32(sQ + warp * 16 * LD + a_lane(lane, LD));
  const unsigned dA = smem_u32(sdO + warp * 16 * LD + a_lane(lane, LD));
  const unsigned bl = b_lane(lane, LD) * 2, btl = bt_lane(lane, LD) * 2;
  unsigned qf[RESIDENT ? KS : 1][4], df[RESIDENT ? KS : 1][4];
  if constexpr (RESIDENT) {
    cp_async_wait<1>();  // Q and dO have landed (kv tile 0 may still be in flight)
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldsm_x4(qA + ks * 32, qf[ks]);
      ldsm_x4(dA + ks * 32, df[ks]);
    }
  }
  // rows gq and gq + 8: lse in log2 units and delta (0 past sq: masked)
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + gq + 8 * i;
    lse2[i] = row < p.sq ? lse[row] * LOG2E : 0.f;
    dlt[i] = row < p.sq ? delta[row] : 0.f;
  }
  const float scale2 = p.scale * LOG2E;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();  // tile kt has landed ...
    __syncthreads();     // ... for every thread; tile kt - 1's buffers are free
    if (kt + 1 < n_kv) {
      stage_tile<D>(sK + ((kt + 1) & 1) * BK * LD, k, p.k_ss, k0 + BK, p.sk);
      stage_tile<D>(sV + ((kt + 1) & 1) * BK * LD, v, p.v_ss, k0 + BK, p.sk);
      cp_async_commit();
    }
    const unsigned kb = smem_u32(sK + (kt & 1) * BK * LD);
    const unsigned vb = smem_u32(sV + (kt & 1) * BK * LD);

    // S = Q K^T and dP = dO V^T: [16 q rows, 64 kv columns]
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned qa[4], da[4];
      if constexpr (RESIDENT) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[ks][e];
          da[e] = df[ks][e];
        }
      } else {
        ldsm_x4(qA + ks * 32, qa);
        ldsm_x4(dA + ks * 32, da);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const unsigned off = bl + (np * 16 * LD + ks * 16) * 2;
        unsigned bk[4], bv[4];
        ldsm_x4(kb + off, bk);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        ldsm_x4(vb + off, bv);
        mma_bf16(dp[2 * np], da, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }

    // P = exp2(S scale2 - lse log2e), dS = P (dP - delta) scale, straight
    // into bf16 A fragments (q x kv, kv the k dim)
    const bool masked = (p.causal && k0 + BK - 1 > w0) || k0 + BK > p.sk || w0 + 16 > p.sq;
    unsigned dsf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2_approx(s[j][e] * scale2 - lse2[e >> 1]);
        if (masked) {
          const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
          const int qpos = w0 + gq + (e >> 1) * 8;
          if ((p.causal && kpos > qpos) || kpos >= p.sk || qpos >= p.sq) pe = 0.f;
        }
        ds[e] = pe * (dp[j][e] - dlt[e >> 1]) * p.scale;
      }
      dsf[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ[16, D] += dS[16, 64] K[64, D]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        unsigned bk[4];
        ldsm_x4_t(kb + btl + (kk * 16 * LD + dn * 16) * 2, bk);
        mma_bf16(acc[2 * dn], dsf[kk], bk[0], bk[1]);
        mma_bf16(acc[2 * dn + 1], dsf[kk], bk[2], bk[3]);
      }
    }
  }

  bf16* dq_out = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<D>(acc, sQ + warp * 16 * LD, LD, dq_out, p.dq_ss, w0, p.sq);
}

// ------------------------------------------- 3xTF32 tensor-core kernels (f32)

// other-side rows a pass: the pass's S and dP tiles, and the P and dS A
// fragments made from them, live in registers beside the warp's [16, D]
// accumulators (64 at d = 64 for dK and dV, 128 at d = 128)
template <int D>
constexpr int TF32_PASS = D <= 64 ? 32 : 16;

template <int D>
constexpr int tf32_smem_bytes(Which which) {
  // two own tiles and two double-buffered other tiles of 64 rows of D + FPAD
  // floats; dkdv adds two [lse 64 | delta 64] rows
  return 6 * 64 * (D + mma_sync::FPAD) * 4 + (which == Which::kDkdv ? 2 * 128 * 4 : 0);
}

// s = own_s . other_s^T and dp = own_p . other_p^T for the warp's 16 own rows
// and NJ n8 tiles of other rows (one pass), summed over d in 3xTF32
// (mma_sync.cuh). A fragments (own rows, [m][k]) through ldmatrix at the byte
// addresses a_* (a_lane), B fragments (other rows, [n][k]) at b_* (b_lane,
// at the pass's first row); each value is split where it is loaded. The sum
// over d (at most 16 k8 steps) stays in one accumulator, fresh each pass.
template <int D, int NJ>
__device__ __forceinline__ void tf32_scores(float (&s)[1][NJ][4], float (&dp)[1][NJ][4],
                                            unsigned a_s, unsigned b_s, unsigned a_p,
                                            unsigned b_p) {
  using namespace mma_sync;
  constexpr int LD = D + FPAD;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[0][j][e] = dp[0][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      unsigned r[4], ab[1][4], as[1][4], bb[NJ][2], bs[NJ][2];
      ldsm_x4((m ? a_p : a_s) + ks * 32, r);
#pragma unroll
      for (int x = 0; x < 4; ++x) split_tf32(r[x], ab[0][x], as[0][x]);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        ldsm_x4((m ? b_p : b_s) + (np * 16 * LD + ks * 8) * 4, r);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split_tf32(r[x], bb[2 * np + (x >> 1)][x & 1], bs[2 * np + (x >> 1)][x & 1]);
      }
      if (m)
        mma_tf32x3(dp, ab, as, bb, bs);
      else
        mma_tf32x3(s, ab, as, bb, bs);
    }
  }
}

// dK/dV in 3xTF32: the bf16 kernel's grid, split, causal order and cp.async
// double buffer of Q, dO, lse and delta, on f32 tiles. Each q tile is taken
// in passes of QC columns: S^T = K_w Q^T and dP^T = V_w dO^T (tf32_scores),
// P^T and dS^T straight into split A fragments, dV += P^T dO and dK += dS^T Q
// (tf32_product).
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dkdv_tf32_kernel(const Params p) {
  using namespace mma_sync;
  constexpr int LD = D + FPAD;
  constexpr int QC = TF32_PASS<D>;   // q columns a pass
  constexpr int NJ = QC / 8;           // n8 tiles of S^T a pass = k8 steps of dV, dK
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // [BK][LD]
  float* sV = sK + BK * LD;                     // [BK][LD]
  float* sQ = sV + BK * LD;                     // 2 x [BQ][LD]
  float* sdO = sQ + 2 * BQ * LD;                // 2 x [BQ][LD]
  float* sStat = sdO + 2 * BQ * LD;             // 2 x [lse | delta]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * BK;  // causal: the first kv tiles see the most q tiles
  const int w0 = k0 + warp * 16;   // this warp's first kv row

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.sq;

  // causal: q tiles that end before this kv tile starts see none of it
  const int n_q = (p.sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? k0 / BQ : 0;
  stage_tile<D>(sK, k, p.k_ss, k0, p.sk);
  stage_tile<D>(sV, v, p.v_ss, k0, p.sk);
  if (qt0 < n_q) {
    stage_tile<D>(sQ, q, p.q_ss, qt0 * BQ, p.sq);
    stage_tile<D>(sdO, dout, p.do_ss, qt0 * BQ, p.sq);
    stage_row_stats(sStat, lse, delta, qt0 * BQ, p.sq);
  }
  cp_async_commit();

  const unsigned kA = smem_u32(sK + warp * 16 * LD + a_lane(lane, LD, 4));
  const unsigned vA = smem_u32(sV + warp * 16 * LD + a_lane(lane, LD, 4));
  const unsigned bl = b_lane(lane, LD, 4) * 4;

  Tf32Acc<D> dk = {}, dv = {};

  for (int qt = qt0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    const int buf = (qt - qt0) & 1;
    cp_async_wait<0>();  // q tile qt has landed ...
    __syncthreads();     // ... for every thread; tile qt - 1's buffers are free
    if (qt + 1 < n_q) {
      stage_tile<D>(sQ + (buf ^ 1) * BQ * LD, q, p.q_ss, q0 + BQ, p.sq);
      stage_tile<D>(sdO + (buf ^ 1) * BQ * LD, dout, p.do_ss, q0 + BQ, p.sq);
      stage_row_stats(sStat + (buf ^ 1) * 128, lse, delta, q0 + BQ, p.sq);
      cp_async_commit();
    }
    const float* tQ = sQ + buf * BQ * LD;
    const float* tdO = sdO + buf * BQ * LD;
    const float* st = sStat + buf * 128;
    const bool masked = (p.causal && w0 + 15 > q0) || q0 + BQ > p.sq || w0 + 16 > p.sk;

#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += QC) {
      float s[1][NJ][4], dp[1][NJ][4];
      tf32_scores<D, NJ>(s, dp, kA, smem_u32(tQ + c0 * LD) + bl, vA,
                         smem_u32(tdO + c0 * LD) + bl);

      // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale, with
      // lse and delta those of the columns (q rows), split into the A
      // fragments of dV's and dK's k8 steps
      unsigned pb[NJ][1][4], ps[NJ][1][4], db[NJ][1][4], dsm[NJ][1][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = c0 + j * 8 + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(st + col);
        const float2 d2 = *reinterpret_cast<const float2*>(st + 64 + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = (e & 1) ? l2.y : l2.x;
          const float delta_c = (e & 1) ? d2.y : d2.x;
          float pe = exp2_approx(fmaf(s[0][j][e], p.scale, -lse_c) * LOG2E);
          if (masked) {
            const int qpos = q0 + col + (e & 1);
            const int kpos = w0 + gq + (e >> 1) * 8;
            if ((p.causal && kpos > qpos) || qpos >= p.sq || kpos >= p.sk) pe = 0.f;
          }
          const float ds = pe * (dp[0][j][e] - delta_c) * p.scale;
          split_tf32(__float_as_uint(pe), pb[j][0][a_slot(e)], ps[j][0][a_slot(e)]);
          split_tf32(__float_as_uint(ds), db[j][0][a_slot(e)], dsm[j][0][a_slot(e)]);
        }
      }
      tf32_product<D, NJ>(dv, pb, ps, tdO + c0 * LD);
      tf32_product<D, NJ>(dk, db, dsm, tQ + c0 * LD);
    }
  }

  cp_async_wait<0>();  // a causal kv tile past sq ran no q tile
  store_rows_f32<D>(dk, static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh, p.dk_ss, w0,
                    p.sk);
  store_rows_f32<D>(dv, static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh, p.dv_ss, w0,
                    p.sk);
}

// dQ in 3xTF32: the bf16 kernel's grid, causal order and cp.async double
// buffer of K and V, on f32 tiles. Each kv tile is taken in passes of KC
// columns: S = Q_w K^T and dP = dO_w V^T (tf32_scores), dS straight into
// split A fragments, dQ += dS K (tf32_product).
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dq_tf32_kernel(const Params p) {
  using namespace mma_sync;
  constexpr int LD = D + FPAD;
  constexpr int KC = TF32_PASS<D>;   // kv columns a pass
  constexpr int NJ = KC / 8;           // n8 tiles of S a pass = k8 steps of dQ
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* sdO = sQ + BQ * LD;                    // [BQ][LD]
  float* sK = sdO + BQ * LD;                    // 2 x [BK][LD]
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
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.sq;

  // causal: kv tiles starting past this tile's last query row contribute nothing
  int n_kv = (p.sk + BK - 1) / BK;
  if (p.causal) {
    const int last_q = min(q0 + BQ, p.sq) - 1;
    n_kv = min(n_kv, last_q / BK + 1);
  }
  stage_tile<D>(sQ, q, p.q_ss, q0, p.sq);
  stage_tile<D>(sdO, dout, p.do_ss, q0, p.sq);
  stage_tile<D>(sK, k, p.k_ss, 0, p.sk);
  stage_tile<D>(sV, v, p.v_ss, 0, p.sk);
  cp_async_commit();

  const unsigned qA = smem_u32(sQ + warp * 16 * LD + a_lane(lane, LD, 4));
  const unsigned dA = smem_u32(sdO + warp * 16 * LD + a_lane(lane, LD, 4));
  const unsigned bl = b_lane(lane, LD, 4) * 4;
  // rows gq and gq + 8: lse and delta (0 past sq: masked)
  float lse_r[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + gq + 8 * i;
    lse_r[i] = row < p.sq ? lse[row] : 0.f;
    dlt[i] = row < p.sq ? delta[row] : 0.f;
  }

  Tf32Acc<D> acc = {};

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();  // tile kt has landed ...
    __syncthreads();     // ... for every thread; tile kt - 1's buffers are free
    if (kt + 1 < n_kv) {
      stage_tile<D>(sK + ((kt + 1) & 1) * BK * LD, k, p.k_ss, k0 + BK, p.sk);
      stage_tile<D>(sV + ((kt + 1) & 1) * BK * LD, v, p.v_ss, k0 + BK, p.sk);
      cp_async_commit();
    }
    const float* tK = sK + (kt & 1) * BK * LD;
    const float* tV = sV + (kt & 1) * BK * LD;
    const bool masked = (p.causal && k0 + BK - 1 > w0) || k0 + BK > p.sk || w0 + 16 > p.sq;

#pragma unroll 1
    for (int c0 = 0; c0 < BK; c0 += KC) {
      float s[1][NJ][4], dp[1][NJ][4];
      tf32_scores<D, NJ>(s, dp, qA, smem_u32(tK + c0 * LD) + bl, dA,
                         smem_u32(tV + c0 * LD) + bl);

      // P = exp(S scale - lse) and dS = P (dP - delta) scale, split into the
      // A fragments of dQ's k8 steps
      unsigned db[NJ][1][4], dsm[NJ][1][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = exp2_approx(fmaf(s[0][j][e], p.scale, -lse_r[e >> 1]) * LOG2E);
          if (masked) {
            const int kpos = k0 + c0 + j * 8 + 2 * tq + (e & 1);
            const int qpos = w0 + gq + (e >> 1) * 8;
            if ((p.causal && kpos > qpos) || kpos >= p.sk || qpos >= p.sq) pe = 0.f;
          }
          const float ds = pe * (dp[0][j][e] - dlt[e >> 1]) * p.scale;
          split_tf32(__float_as_uint(ds), db[j][0][a_slot(e)], dsm[j][0][a_slot(e)]);
        }
      }
      tf32_product<D, NJ>(acc, db, dsm, tK + c0 * LD);
    }
  }

  store_rows_f32<D>(acc, static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh, p.dq_ss, w0,
                    p.sq);
}

template <int D>
cudaError_t launch_mma(Which which, const Params& p, int bh, cudaStream_t stream) {
  if (which == Which::kDkdv) {
    constexpr int smem = dkdv_mma_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(bh, (p.sk + BK - 1) / BK);
    flash_bwd_dkdv_mma_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  } else {
    constexpr int smem = dq_mma_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(bh, (p.sq + BQ - 1) / BQ);
    flash_bwd_dq_mma_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(Which which, const Params& p, int bh, cudaStream_t stream) {
  if (which == Which::kDkdv) {
    constexpr int smem = tf32_smem_bytes<D>(Which::kDkdv);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(bh, (p.sk + BK - 1) / BK);
    flash_bwd_dkdv_tf32_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  } else {
    constexpr int smem = tf32_smem_bytes<D>(Which::kDq);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(bh, (p.sq + BQ - 1) / BQ);
    flash_bwd_dq_tf32_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

// The tensor-core routes, bf16 (f32 = false) or 3xTF32 (f32 = true): every
// operand and output 16-byte aligned, with batch, seq and head strides
// multiples of 8 bf16 or 4 f32 elements (cp.async and the epilogues move
// 16-byte pieces); else cudaErrorInvalidValue.
int run_tc(Which which, const Params& p, bool f32, int head_dim, int batch, void* stream) {
  const int bh = batch * p.heads;
  if (bh == 0 || p.sq == 0 || p.sk == 0) return static_cast<int>(cudaErrorInvalidValue);
  using mma_sync::aligned16;
  const int vec = f32 ? 4 : 8;
  const bool ok =
      aligned16(p.q, {p.q_sb, p.q_ss, p.q_sh}, vec) &&
      aligned16(p.k, {p.k_sb, p.k_ss, p.k_sh}, vec) &&
      aligned16(p.v, {p.v_sb, p.v_ss, p.v_sh}, vec) &&
      aligned16(p.dout, {p.do_sb, p.do_ss, p.do_sh}, vec) &&
      (which == Which::kDkdv ? aligned16(p.dk, {p.dk_sb, p.dk_ss, p.dk_sh}, vec) &&
                                   aligned16(p.dv, {p.dv_sb, p.dv_ss, p.dv_sh}, vec)
                             : aligned16(p.dq, {p.dq_sb, p.dq_ss, p.dq_sh}, vec));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (head_dim) {
    case 32: e = f32 ? launch_tf32<32>(which, p, bh, st) : launch_mma<32>(which, p, bh, st); break;
    case 64: e = f32 ? launch_tf32<64>(which, p, bh, st) : launch_mma<64>(which, p, bh, st); break;
    case 128:
      e = f32 ? launch_tf32<128>(which, p, bh, st) : launch_mma<128>(which, p, bh, st);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
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

// the dK/dV call's Params: outputs dk, dv with strides[12..17]
Params dkdv_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int heads, int sq,
                   int sk, const long long* strides, float scale, int causal) {
  Params p = common(q, k, v, dout, lse, delta, heads, sq, sk, strides, strides + 3,
                    strides + 6, strides + 9, scale, causal);
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = strides[12]; p.dk_ss = strides[13]; p.dk_sh = strides[14];
  p.dv_sb = strides[15]; p.dv_ss = strides[16]; p.dv_sh = strides[17];
  return p;
}

// the dQ call's Params: output dq with strides[12..14]
Params dq_params(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int heads, int sq, int sk,
                 const long long* strides, float scale, int causal) {
  Params p = common(q, k, v, dout, lse, delta, heads, sq, sk, strides, strides + 3,
                    strides + 6, strides + 9, scale, causal);
  p.dq = dq;
  p.dq_sb = strides[12]; p.dq_ss = strides[13]; p.dq_sh = strides[14];
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
  return run(Which::kDkdv,
             dkdv_params(q, k, v, dout, lse, delta, dk, dv, heads, sq, sk, strides, scale,
                         causal),
             dtype, head_dim, batch, stream);
}

// dQ: [batch, sq, heads, head_dim] (strides[12..14]).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int dtype, int head_dim, int batch,
                                      int heads, int sq, int sk, const long long* strides,
                                      float scale, int causal, void* stream) {
  return run(Which::kDq,
             dq_params(q, k, v, dout, lse, delta, dq, heads, sq, sk, strides, scale, causal),
             dtype, head_dim, batch, stream);
}

// The tensor-core pairs: operands and outputs as the two entries above take
// them (no dtype argument: bf16 for _mma, f32 for _tf32), aligned as run_tc
// says.
extern "C" int flash_attention_bwd_dkdv_mma(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv,
                                            int head_dim, int batch, int heads, int sq,
                                            int sk, const long long* strides, float scale,
                                            int causal, void* stream) {
  return run_tc(Which::kDkdv,
                dkdv_params(q, k, v, dout, lse, delta, dk, dv, heads, sq, sk, strides, scale,
                            causal),
                false, head_dim, batch, stream);
}

extern "C" int flash_attention_bwd_dq_mma(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, int head_dim,
                                          int batch, int heads, int sq, int sk,
                                          const long long* strides, float scale, int causal,
                                          void* stream) {
  return run_tc(Which::kDq,
                dq_params(q, k, v, dout, lse, delta, dq, heads, sq, sk, strides, scale, causal),
                false, head_dim, batch, stream);
}

extern "C" int flash_attention_bwd_dkdv_tf32(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dk, void* dv,
                                             int head_dim, int batch, int heads, int sq,
                                             int sk, const long long* strides, float scale,
                                             int causal, void* stream) {
  return run_tc(Which::kDkdv,
                dkdv_params(q, k, v, dout, lse, delta, dk, dv, heads, sq, sk, strides, scale,
                            causal),
                true, head_dim, batch, stream);
}

extern "C" int flash_attention_bwd_dq_tf32(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dq, int head_dim,
                                           int batch, int heads, int sq, int sk,
                                           const long long* strides, float scale, int causal,
                                           void* stream) {
  return run_tc(Which::kDq,
                dq_params(q, k, v, dout, lse, delta, dq, heads, sq, sk, strides, scale, causal),
                true, head_dim, batch, stream);
}
