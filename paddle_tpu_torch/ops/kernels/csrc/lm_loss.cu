// Fused LM head + softmax cross entropy for Hopper (sm_90a), CUDA C++: the
// forward with an online logsumexp over vocab tiles, and the two backward
// kernels (dh with the row tile as the outer loop, dW with the vocab tile).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/lm_loss.py:
// `_fwd_kernel` (pl.pallas_call at line 162, `_fwd`), `_dh_kernel` (line 261)
// and `_dw_kernel` (line 279, both in `_bwd`). Same results:
//   s = h . W^T with f32 accumulation, W rounded to h's dtype first (the
//       TPU wrapper's `w.astype(h2.dtype)`; here on load, with no copy);
//   forward: running max m and sum l in f32 over vocab tiles, l = l *
//       exp(m_old - m_new) + sum exp(s - m_new); lse = m + log(l); the label's
//       logit picked from the tile that holds it; loss = lse - picked;
//   backward: p = exp(s - lse) from the forward's lse; dl = (p - onehot) * g;
//       dl rounded to the product dtype before dh += dl . W and dW += dl^T . h;
//       f32 accumulators; dh in h's dtype, dW in W's own dtype.
// Vocab columns past v_true are masked to the finite NEG_INF by index, so
// nothing pads W (the TPU wrapper pads it to a multiple of 512 with a copy);
// dW has exactly V rows. A label outside [0, V) picks nothing (loss = lse,
// gradient softmax * g), which is what the TPU kernel gives for -100.
//
// Blocking (not the TPU's): every kernel multiplies a 32-row tile of its "own"
// operand by 128-row tiles of the "other" one, with the hidden dim as a loop
// of 32-deep slices staged transposed in shared memory. 256 threads: warp ty
// owns own-rows ty*4..+3, lane tx other-rows tx*4..+3, so a row statistic is
// one warp shuffle and the own-side operand is a broadcast.
//   forward: own = h rows, other = W rows; the vocab is split over gridDim.y
//       CTAs per row tile (each keeps (m, l, picked) in registers), and a
//       second kernel merges the partials in a fixed order.
//   dh: own = h rows (one CTA per 32 rows, all vocab tiles in a loop);
//   dw: own = W rows (one CTA per 32 vocab rows, all row tiles in a loop).
//   Both keep their [32, chunk of H] f32 accumulator in registers (24 floats
//   of 128 columns a thread; H in chunks of up to 1024 over gridDim.y, each
//   chunk recomputing S), write dl of the tile to shared memory, then stream
//   the other operand's [16, chunk] slices through shared memory for dl . B.
// No atomics: the results are deterministic.
//
// Bound at GPT-2 124M's shapes (N = 8192 rows, H = 768, V = 50304):
//   forward 2 N V H = 633 GFLOP: 0.64 ms on bf16 tensor cores, 9.45 ms on
//   the FP32 units; dh and dw 4 N V H = 1.27 TFLOP each (recompute S, then
//   the product): 1.28 ms bf16, 18.9 ms FP32. Bytes are far below (W is
//   77 MB in bf16). This first version does every product with FMA on the FP32
//   units, so its floor is the FP32 one; what it does about the bound: S,
//   p and dl never leave the chip, each staged tile is reused by 32 or 128
//   rows, the forward splits the vocab so that ~1000 CTAs fill 132 SMs.
//   The FMA backward is the tensor-core backwards' predecessor, and the
//   route only past their cluster limit (H > 6144, bit for bit as it was);
//   the FMA forward is the predecessor of both tensor-core forwards, timed
//   beside them, and no route takes it.
//
// The tensor-core backward (lm_grad_mma_kernel, the route for bf16 h): dh
// and dW again as one template with the roles swapped, now with both
// products on the bf16 tensor cores (mma.sync.m16n8k16, f32 accumulation),
// operands from shared memory through ldmatrix. It reads W in bf16: the
// wrapper makes one bf16 copy of an f32 W and hands it to both kernels (the
// TPU wrapper's `w.astype(h2.dtype)`), so tiles go straight from device
// memory to shared memory with cp.async, unconverted. dW still comes out in
// the original W's dtype.
//   Bound: the same 1.28 ms of operations each (4 N V H on the tensor
//   cores); the operand streams are ~20 GB a kernel (every CTA reads the
//   whole other operand), mostly from L2, since the CTAs in flight walk the
//   tiles in step.
//   Design: 256 threads, 8 warps, 1 CTA an SM. The own tile [32, H] bf16
//   is loaded once and stays; the other operand streams in [32, H] bf16
//   tiles through a cp.async double buffer (tile t+1 is in flight while
//   tile t computes; rows past the end are zero-filled through cp.async's
//   src-size, so the inner loops have no edge branch). Per tile, three
//   phases between barriers:
//   - S = own . other^T split over the hidden dim: warp w computes all 32
//     own rows x 16 other rows over the hidden quarter w / 2 (plain
//     ldmatrix for both: H is contiguous in both), and the four f32
//     partials meet in shared memory (20 KB);
//   - dl = (exp(S - lse) - onehot) * g: a thread sums 4 elements' partials
//     in a fixed order, computes dl in f32 and rounds it to bf16 into a
//     [32, 32] tile;
//   - acc += dl . other: warp w owns the 16-column pairs c0 + (j*8 + w)*16
//     for all 32 own rows (dl through ldmatrix, other through
//     ldmatrix.trans: its rows are now the k dimension).
//   The split makes every warp read each shared fragment once (~290 KB of
//   shared-memory traffic a tile); a layout of 16 x 8 blocks of S over the
//   full H, which reads the own tile 4 times and the other 3 times a tile
//   (~450 KB), took 22% longer (PERF.md). The [32 own, chunk] f32
//   accumulator lives in registers, 96 floats a thread at chunk 768. 32
//   own rows, not 64: 64 would need 192 accumulator registers a thread, or
//   two hidden chunks and 1.5x the operations. Wider H goes in chunks of
//   <= 768 columns over gridDim.y, each chunk recomputing S over the full
//   H (which stays in shared memory); above H = 1024 the two other tiles no
//   longer fit beside the own tile and the tile is single-buffered (the
//   plan in lm_loss.py picks it; H <= 1536). Past H = 1536 the own tile
//   does not fit at all, and the hidden dim splits across a cluster (the
//   cluster route below). Rows are padded by 16 bytes
//   (not swizzled): a row of H bf16 is a multiple of 256 bytes, so without
//   the pad the 8 rows of an ldmatrix all start in one bank; with it they
//   start 4 banks apart. No atomics and a fixed summation order: two calls
//   give the same bits.
//   Left for wgmma: at 8 warps an SM and three barriers a tile, each
//   phase's latency shows (~4,300 cycles a tile against ~2,300 of
//   shared-memory traffic); a wgmma version reads both operands from
//   shared memory by descriptor, with TMA filling a deeper ring and a
//   producer warp, so the phases of consecutive tiles overlap. The device
//   code that issues the products (the S loop and the dl . other loop) is
//   the one place to change.
//
// The 3xTF32 backward (lm_grad_tf32_kernel, the route for f32 h up to H =
// 768): both products on the TF32 tensor cores (mma.sync.m16n8k8), each
// operand split into a TF32 big part and a TF32 small part and three
// products summed, a_small b_big + a_big b_small + a_big b_big
// (mma_sync.cuh), which holds f32 accuracy: one TF32 pass errs by ~2e-4 of
// the gradient's norm. dl stays f32. W is read in f32 (the wrapper casts a
// bf16 W once per backward, exactly).
//   Bound: 3 x 4 N V H = 3.8 TFLOP each on the TF32 tensor cores (495
//   TFLOP/s): 7.67 ms; the f32 work alone on the FP32 units: 18.9 ms.
//   Design: the bf16 kernel's 32 resident own rows and [32, chunk] register
//   accumulator, with f32 rows padded by 16 bytes. The own tile takes
//   98,816 bytes at H = 768, so the other operand streams in 16-row tiles
//   through a cp.async double buffer (2 x 49,408 bytes; one single-buffered
//   32-row tile was 3% slower), copied by rows and lanes: mma_sync.cuh's
//   stage_rows divides by the row width for each 16-byte piece, 8% of the
//   time here. Past H = 768 nothing fits, and the hidden dim splits across
//   a cluster (below).
//   The TF32 mma.sync pipe takes ~7.7 cycles a product (the marginal cost
//   of a pass, PERF.md), so three passes alone take ~16 ms. S = own .
//   other^T is split over the hidden dim in eighths, one a warp, so that
//   each warp's 2 x 2 fragments of a k8 step feed 4 products; the eight
//   f32 partials meet in shared memory. Its fragments come through ldmatrix
//   as at bf16 (an f32 [m][k] tile's 8 x 4 blocks are ldmatrix's 8 x 8 b16
//   blocks). The dl . other product's B is the other tile read k-major,
//   which ldmatrix cannot transpose at 32 bits: scalar loads (two lanes to
//   a bank; a k permutation that avoids it measured slower). Each fragment
//   is split where it is loaded (three ALU instructions a value,
//   split_tf32), so a k8 step of S issues 12 mma and 36 ALU instructions.
//   The tensor core truncates as it accumulates, and a
//   gradient sums 8192 or 50304 products: kept in one accumulator, that
//   drifted to 1e-4 of the result. So each 16 hidden columns of S and each
//   tile of the product are summed in a fresh accumulator and added to the
//   running sums in f32. No atomics and a fixed order: two calls give the
//   same bits.
//
// The cluster route of both tensor-core backwards (the CLUSTER instances:
// f32 h past H = 768, bf16 h past 1536, up to H = 6144): a thread-block
// cluster of c CTAs on c SMs shares one 32-row own tile, split along the
// hidden dim. Rank r holds the own tile's columns [r * chunk, + chunk)
// resident, streams the same columns of each other tile, computes its
// partial S over them, and accumulates only those columns of the gradient
// from the other slice it already holds. chunk = ceil(units / c) x 128
// (units = H / 128; the last slice may be narrower), so the one-CTA
// kernels' tiles, accumulator instances and stagers serve as they are.
//   The partial S meet through distributed shared memory (mma_sync.cuh):
// each CTA sums its warps' partials as before and writes the [32, 16|32]
// result to a slot of its shared memory; after a cluster barrier every CTA
// reads that slot of every rank and adds them in f32 in rank order
// 0..c-1, so that all get the same S and dl (two calls give the same bits;
// no atomics). Slots alternate between two buffers, so one barrier a tile
// orders a rank's reads of tile t before its peers write tile t + 2, and a
// last arrive / wait keeps a CTA's shared memory until its peers are done.
// Nothing is recomputed: gridDim.y's chunks recompute S over the full H for
// each chunk, the cluster's ranks compute it once between them.
//   Pipelined (ST 3): with a ring of three other tiles, a CTA arrives at
// the barrier once tile t's partial S is in its slot and waits a half tile
// later: in between runs the product of tile t - 1 while tile t + 2 loads;
// the reads of the peers' slots are then in flight through the S of tile t
// + 1, and summed after it. The arrive is one thread's cluster-scope
// release fence after a CTA barrier, all threads arriving relaxed: a
// release arrive in every thread cost 15% (the barrier's latency itself
// hides behind the pipeline; issuing the prefetch after the arrive did not
// help; PERF.md). Three [32, 768] bf16 tiles fit beside the own tile
// (229,888 bytes), three [16, 768] f32 ones do not: f32 slices are at most
// 512 columns (c = ceil(units / 4)) while 8 CTAs cover H (H <= 4096), and
// past that at most 768 over two buffers in order (ST 2, the barrier inside
// each tile). bf16 slices are at most 768 (c = ceil(units / 6)). H = 1024
// f32 splits 512 + 512 (c 2), 2048 into 4 x 512; bf16 2048 768 + 768 + 512.
//   Bound at gpt_345m's head (N = 8192, V = 50304, H = 1024, f32): 3 x 4 N
// V H = 5.06 TFLOP each on the TF32 tensor cores, 10.2 ms; gpt_1p3b's
// (H = 2048, bf16): 4 N V H = 3.38 TFLOP each, 3.41 ms. The launch
// (cudaLaunchKernelEx with the cluster dimension; grid x = own tiles x c)
// first asks cudaOccupancyMaxActiveClusters once an instance and cluster
// size, and returns an error where the card cannot hold one cluster.

// The tensor-core forwards (lm_fwd_mma_*, the route for bf16 h, and
// lm_fwd_tf32_full, the route for f32 h): a GEMM with a row-reduction
// epilogue, one body (fwd_mma_body) for both dtypes: on mma.sync.m16n8k16
// bf16 with f32 accumulation, or on mma.sync.m16n8k8 TF32 in 3xTF32 (each
// operand split into a TF32 big and small part and three products summed,
// f32 accuracy). W is read in h's dtype (the wrapper casts a W of the other
// dtype once a call, inside the call's time; to f32 exactly).
//   Bound: 2 N V H = 633 GFLOP, 0.64 ms on the bf16 tensor cores.
//   Tiles: a CTA takes 128 rows of h against 128-row vocab tiles, 8 warps of
//   32 x 64. It has none of the backward's [32, H] f32 accumulator, so the
//   row tile is not capped at 32: every W tile read from L2 feeds 128 rows
//   (the work per byte read grows with the rows a tile). The hidden dim
//   streams in 64-column slices (rows of 128 bytes, padded by 16 so an
//   ldmatrix's 8 rows fall in distinct banks) through a 3-stage cp.async
//   ring that runs on across tile boundaries, so any hidden that is a
//   multiple of 64 fits: 3 x 256 rows x 144 bytes = 108 KB, two CTAs an SM.
//   64 accumulator floats a thread; each k step of 16 reads 2 A and 4 B
//   fragments for 16 mma.
//   Epilogue: each thread keeps a running (m, l) per row over only the
//   columns it holds, in log2 units (exp2 on the MUFU), so a tile costs no
//   shuffle; the partials of a row merge once at the end over the quad and
//   the two warp columns, in a fixed order. The vocab splits over gridDim.y
//   (lm_loss_fwd_mma_splits: 2112 CTAs, 8 waves of 2 an SM on 132 SMs, a
//   function of the shapes only) and lm_merge_kernel merges the splits in
//   order: no atomics, and two calls give the same bits.
//   3xTF32 at f32 h: bound 3 x 2 N V H = 1.90 TFLOP at 495 TFLOP/s, 3.84
//   ms (the FP32 units' bound of the same work at f32: 9.45 ms). The same
//   tiles, ring (a stage now 32 hidden columns: the same 128 bytes a row,
//   so any H a multiple of 128 still fits, with no cap) and epilogue; each
//   k8 step loads 2 A and 4 B fragments through ldmatrix, splits their 24
//   values (3 ALU instructions each) and issues 48 mma. The tensor core
//   truncates as it accumulates: one accumulator across the hidden loop
//   (288 products into each at H = 768) moved the loss by 1.3e-5, and at H
//   = 1280 the lse by enough to push the backward's dh past its f32 limit
//   (PERF.md), so each slice (12 products) goes into a fresh accumulator,
//   added to S in f32. That takes 64 more registers: beside the split
//   fragments (48), more than the 128 a thread of two CTAs an SM, so it
//   runs one (8 warps) an SM, 16 waves of the same 2112 CTAs. mma.sync's
//   TF32 pipe takes ~7.7 cycles a product on each sub-partition, so the
//   three passes alone need ~7.7 ms at this shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace {

constexpr int NT = 256;
constexpr int BA = 32;          // own rows a CTA
constexpr int BB = 128;         // other rows a tile
constexpr int BK = 32;          // hidden slice of the S product
constexpr int AST = BA + 4;     // row stride of transposed own slices (16-byte aligned)
constexpr int BST = BB + 4;     // row stride of transposed other slices
constexpr int CV = 16;          // other rows a slice of the gradient product
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
// x rounded to T and widened back (the reference's .astype before a product)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// 4 consecutive elements as floats (16-byte load in f32, 8-byte in bf16)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// 4 elements of row r at column c of a [rows, hdim] matrix, rounded to the
// product dtype TC; zeros past the rows
template <typename TC, typename T>
__device__ __forceinline__ void load4_rounded(const T* m, int r, int rows, int hdim, int c,
                                              float (&v)[4]) {
  if (r < rows) {
    load4(m + static_cast<long long>(r) * hdim + c, v);
    if constexpr (!std::is_same<T, TC>::value) {  // a stored TC value is exact
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = round_to<TC>(v[q]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// s[i][j] = A[a0 + ty*4 + i] . B[b0 + tx*4 + j] over the hidden dim, both
// operands rounded to TC, f32 FMA. sA: [BK][AST], sB: [BK][BST].
template <typename TC, typename TA, typename TB>
__device__ __forceinline__ void tile_product(const TA* A, int a0, int na, const TB* B, int b0,
                                             int nb, int hdim, float* sA, float* sB,
                                             float (&s)[4][4]) {
  const int tid = threadIdx.x;
  const int ty = tid >> 5, tx = tid & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int k0 = 0; k0 < hdim; k0 += BK) {
    __syncthreads();  // the previous slice's reads are done
    {
      const int r = tid >> 3, kc = (tid & 7) * 4;  // 32 rows x 8 chunks
      float v[4];
      load4_rounded<TC>(A, a0 + r, na, hdim, k0 + kc, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) sA[(kc + q) * AST + r] = v[q];
    }
#pragma unroll
    for (int it = 0; it < 4; ++it) {                 // 128 rows x 8 chunks
      const int idx = tid + it * NT;
      const int r = idx >> 3, kc = (idx & 7) * 4;
      float v[4];
      load4_rounded<TC>(B, b0 + r, nb, hdim, k0 + kc, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) sB[(kc + q) * BST + r] = v[q];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(sA + k * AST + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(sB + k * BST + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
  }
}

struct FwdParams {
  const void* h;        // [n, hdim]
  const void* w;        // [v, hdim]
  const int* labels;    // [n]
  float* part;          // [3][splits][n]: m, l, picked
  int n, v, hdim;
  int v_true;           // columns >= v_true are masked to NEG_INF
};

// One CTA: 32 rows of h against the vocab tiles blockIdx.y, +gridDim.y, ...
// The label's logit is accumulated and columns >= v_true are masked.
// Columns past v (the last tile's edge) never count.
template <typename TH, typename TW>
__device__ __forceinline__ void fwd_body(const FwdParams& p) {
  __shared__ float sA[BK * AST];
  __shared__ float sB[BK * BST];
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
  const int r0 = blockIdx.x * BA;
  const TH* h = static_cast<const TH*>(p.h);
  const TW* w = static_cast<const TW*>(p.w);

  int lab[4];
  float m[4], l[4], pk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    lab[i] = r < p.n ? p.labels[r] : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
    pk[i] = 0.f;
  }
  const int n_vt = (p.v + BB - 1) / BB;
  for (int vt = blockIdx.y; vt < n_vt; vt += gridDim.y) {
    const int v0 = vt * BB;
    float s[4][4];
    tile_product<TH>(h, r0, p.n, w, v0, p.v, p.hdim, sA, sB, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx * 4 + j;
        float x = s[i][j];
        if (col >= p.v_true) x = NEG_INF;
        if (col == lab[i] && col < p.v) pk[i] += x;
        if (col >= p.v) x = -INFINITY;  // not a column: adds exactly 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
      rs = warp_sum(rs);
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }
  const long long plane = static_cast<long long>(gridDim.y) * p.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float picked = warp_sum(pk[i]);  // one lane holds it
    const int r = r0 + ty * 4 + i;
    if (tx == 0 && r < p.n) {
      const long long o = static_cast<long long>(blockIdx.y) * p.n + r;
      p.part[o] = m[i];
      p.part[plane + o] = l[i];
      p.part[2 * plane + o] = picked;
    }
  }
}

// Merge the vocab splits of each row in order: lse = M + log(sum l_s
// exp(m_s - M)), loss = lse - sum picked_s.
__global__ void __launch_bounds__(NT) lm_merge_kernel(const float* __restrict__ part, int splits,
                                                      int n, float* __restrict__ loss,
                                                      float* __restrict__ lse) {
  const int r = blockIdx.x * NT + threadIdx.x;
  if (r >= n) return;
  const long long plane = static_cast<long long>(splits) * n;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part[static_cast<long long>(s) * n + r]);
  float l = 0.f, pk = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long o = static_cast<long long>(s) * n + r;
    l += part[plane + o] * expf(part[o] - mx);
    pk += part[2 * plane + o];
  }
  const float z = mx + logf(l);
  lse[r] = z;
  loss[r] = z - pk;
}

struct GradParams {
  const void* h;        // [n, hdim]
  const void* w;        // [v, hdim]
  const int* labels;    // [n]
  const float* lse;     // [n]
  const float* g;       // [n] cotangent of the loss
  void* out;            // dh [n, hdim] (h's dtype) or dw [v, hdim] (w's dtype)
  int n, v, hdim;
  int chunk;            // hidden columns a CTA accumulates (HC * 128 or less)
};

template <int HC>
constexpr int grad_smem_floats() {
  return BK * AST + BK * BST + BB * AST + CV * HC * 128;
}

// DW = false: dh, own = h rows, other = W rows (vocab tiles).
// DW = true:  dw, own = W rows, other = h rows (row tiles).
// blockIdx.x: own tile of 32 rows; blockIdx.y: hidden chunk of p.chunk columns.
template <typename TH, typename TW, bool DW, int HC>
__global__ void __launch_bounds__(NT, 1) lm_grad_kernel(const GradParams p) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);   // [BK][AST]
  float* sB = sA + BK * AST;                     // [BK][BST]
  float* sDL = sB + BK * BST;                    // [BB][AST]  dl[own][other], transposed
  float* sC = sDL + BB * AST;                    // [CV][HC * 128]  other rows, chunk cols
  constexpr int CW = HC * 128;
  const int tid = threadIdx.x;
  const int ty = tid >> 5, tx = tid & 31;
  const int a0 = blockIdx.x * BA;
  const int c0 = blockIdx.y * p.chunk;
  const int c_end = min(c0 + p.chunk, p.hdim);
  const TH* h = static_cast<const TH*>(p.h);
  const TW* w = static_cast<const TW*>(p.w);
  const int na = DW ? p.v : p.n;
  const int nb = DW ? p.n : p.v;

  // dh: the own rows are tokens, their lse, g and label load once
  float own_lse[4], own_g[4];
  int own_lab[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = a0 + ty * 4 + i;
    const bool ok = !DW && r < p.n;
    own_lse[i] = ok ? p.lse[r] : 0.f;
    own_g[i] = ok ? p.g[r] : 0.f;
    own_lab[i] = ok ? p.labels[r] : -1;
  }

  float acc[4][HC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HC; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][c][q] = 0.f;

  const int n_bt = (nb + BB - 1) / BB;
  for (int bt = 0; bt < n_bt; ++bt) {
    const int b0 = bt * BB;
    float s[4][4];
    if constexpr (DW)
      tile_product<TH>(w, a0, na, h, b0, nb, p.hdim, sA, sB, s);
    else
      tile_product<TH>(h, a0, na, w, b0, nb, p.hdim, sA, sB, s);

    // dl = (exp(s - lse) - onehot) * g, rounded to the product dtype
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + tx * 4 + j;
      float b_lse = 0.f, b_g = 0.f;
      int b_lab = -1;
      if (DW && b < p.n) {
        b_lse = p.lse[b];
        b_g = p.g[b];
        b_lab = p.labels[b];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = a0 + ty * 4 + i;
        const int tok = DW ? b : a, voc = DW ? a : b;
        const float z = DW ? b_lse : own_lse[i];
        const float gg = DW ? b_g : own_g[i];
        const int lb = DW ? b_lab : own_lab[i];
        const float pr = expf(s[i][j] - z);
        const float d = (pr - (voc == lb ? 1.f : 0.f)) * gg;
        const bool ok = tok < p.n && voc < p.v;
        sDL[(tx * 4 + j) * AST + ty * 4 + i] = ok ? round_to<TH>(d) : 0.f;
      }
    }

    // acc[own][chunk cols] += dl[own][b] * other[b][chunk cols]
    for (int cb = 0; cb < BB; cb += CV) {
      __syncthreads();  // sDL is written; the previous slice's reads of sC are done
      for (int idx = tid; idx < CV * CW / 4; idx += NT) {
        const int r = idx / (CW / 4), cc = (idx % (CW / 4)) * 4;
        const int col = c0 + cc;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (col < c_end) {
          if constexpr (DW)
            load4_rounded<TH>(h, b0 + cb + r, nb, p.hdim, col, v);
          else
            load4_rounded<TH>(w, b0 + cb + r, nb, p.hdim, col, v);
        }
        *reinterpret_cast<float4*>(sC + r * CW + cc) = make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
#pragma unroll 4
      for (int bb = 0; bb < CV; ++bb) {
        const float4 a = *reinterpret_cast<const float4*>(sDL + (cb + bb) * AST + ty * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int c = 0; c < HC; ++c) {
          const float4 b = *reinterpret_cast<const float4*>(sC + bb * CW + c * 128 + tx * 4);
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][c][q] = fmaf(av[i], bv[q], acc[i][c][q]);
        }
      }
    }
  }

  using TO = typename std::conditional<DW, TW, TH>::type;
  TO* out = static_cast<TO*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty * 4 + i;
    if (a >= na) continue;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const int col = c0 + c * 128 + tx * 4;
      if (col < c_end) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          out[static_cast<long long>(a) * p.hdim + col + q] = from_f<TO>(acc[i][c][q]);
      }
    }
  }
}

// hidden chunk width in 128-column units for hdim: the smallest of {2, 6, 8}
// that covers hdim / 128 in ceil(hdim / 1024) chunks
int pick_hc(int hdim, int* chunks) {
  const int units = hdim / 128;
  *chunks = (units + 7) / 8;
  const int need = (units + *chunks - 1) / *chunks;
  return need <= 2 ? 2 : need <= 6 ? 6 : 8;
}

template <typename TH, typename TW, bool DW, int HC>
cudaError_t grad_launch(GradParams p, int chunks, cudaStream_t st) {
  constexpr int smem = grad_smem_floats<HC>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(lm_grad_kernel<TH, TW, DW, HC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int na = DW ? p.v : p.n;
  p.chunk = ((p.hdim / 128 + chunks - 1) / chunks) * 128;
  const dim3 grid((na + BA - 1) / BA, chunks);
  lm_grad_kernel<TH, TW, DW, HC><<<grid, NT, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename TH, typename TW, bool DW>
cudaError_t grad_dispatch(const GradParams& p, cudaStream_t st) {
  int chunks;
  switch (pick_hc(p.hdim, &chunks)) {
    case 2: return grad_launch<TH, TW, DW, 2>(p, chunks, st);
    case 6: return grad_launch<TH, TW, DW, 6>(p, chunks, st);
    case 8: return grad_launch<TH, TW, DW, 8>(p, chunks, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TH, typename TW>
cudaError_t grad_which(const GradParams& p, int dw, cudaStream_t st) {
  return dw ? grad_dispatch<TH, TW, true>(p, st) : grad_dispatch<TH, TW, false>(p, st);
}

bool shape_ok(int n, int v, int hdim) {
  return n > 0 && v > 0 && hdim > 0 && hdim % 128 == 0;
}

// ----------------------------------------------------- tensor-core backward

constexpr int MB = 32;          // own rows a CTA: 2 warp rows of 16
constexpr int OB = 32;          // other rows a staged tile: 4 warp columns of 8 in S
using mma_sync::MPAD;           // bf16 a row of padding (16 bytes)
constexpr int DLD = OB + MPAD;  // row stride of the dl tile (bf16)
constexpr int KQ = 4;           // hidden quarters of the S product
constexpr int PST = OB + 8;     // row stride of the S partials (f32)
constexpr int MAX_SMEM = 232448;

// the resident [32, width] own tile and `stages` [32, width] other tiles
// (width: H, or a cluster's hidden slice), rows padded by 16 bytes; the
// [32, 40] bf16 dl tile, four [32, 40] f32 partials of S and, in a cluster,
// two [32, 32] f32 slots of the CTA's partial S
int mma_smem_bytes(int width, int stages, bool cluster = false) {
  return ((1 + stages) * MB * (width + MPAD) + MB * DLD) * 2 + KQ * MB * PST * 4 +
         (cluster ? 2 * MB * OB * 4 : 0);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

struct MmaParams {
  const void* own;              // dh: h [n, hdim]; dW: W [v, hdim] (the operand type)
  const void* other;            // dh: W; dW: h
  const int* labels;            // [n]
  const float* lse;             // [n]
  const float* g;               // [n]
  void* out;                    // dh [n, hdim] in h's dtype; dW [v, hdim] in TO
  int n, v, hdim;
  int chunk;                    // hidden columns a CTA accumulates (<= HC * 128)
};

// a CTA's [32 own, chunk] accumulator (warp w holds the pairs of columns
// c0 + (j * 8 + w) * 16, the m16 tiles m, the n8 tiles e) -> rows a0.. of
// the output, in TO
template <typename TO, int HC>
__device__ __forceinline__ void store_acc(const float (&acc)[HC][2][2][4], unsigned active,
                                          TO* out, int a0, int na, int c0, int hdim) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < HC; ++j) {
    if (!(active & (1u << j))) continue;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + (j * 8 + warp) * 16 + e * 8 + 2 * tq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int a = a0 + m * 16 + gq + 8 * i;
          if (a < na)
            store2(out + static_cast<long long>(a) * hdim + col, acc[j][m][e][2 * i],
                   acc[j][m][e][2 * i + 1]);
        }
      }
  }
}

// DW = false: dh (own = h rows, other = W rows); DW = true: dW (own = W rows,
// other = h rows). TO: the output's dtype. HC: the accumulator's width in
// 128-column units (a warp holds HC pairs of n8 tiles for both own m16
// tiles). ST: other-tile buffers (2: double-buffered; 1 where two do not fit;
// 3: in a cluster, pipelined across the cluster barrier).
// CLUSTER false: blockIdx.x is an own tile of 32 rows, blockIdx.y a hidden
// chunk of p.chunk columns, and every CTA stages the full H and computes S
// over it. CLUSTER true: the cluster's CTAs (along x) share one own tile;
// rank r stages and accumulates the hidden slice r * p.chunk .. (+ p.chunk,
// at most H), computes S over it, and the ranks' partial S are summed in
// rank order through distributed shared memory (cluster_sum; in the
// pipelined loop, ST 3, its halves apart), so that every CTA gets the same
// dl.
// S phase: warp w computes S[32 own, 16 other (w & 1)] over the hidden
// quarter w >> 1 (of the staged columns); the four partials meet in shared
// memory. dl phase: thread t owns S[t / 8][(t % 8) * 4 .. + 3]. Product
// phase: warp w owns the pairs of columns c0 + (j * 8 + w) * 16, all 32 own
// rows.
template <bool DW, typename TO, int HC, int ST, bool CLUSTER>
__global__ void __launch_bounds__(NT, 1) lm_grad_mma_kernel(const MmaParams p) {
  using namespace mma_sync;
  extern __shared__ float4 smem4[];
  const int cl = CLUSTER ? static_cast<int>(cluster_nctarank()) : 1;
  const int c0 = (CLUSTER ? static_cast<int>(cluster_ctarank()) : blockIdx.y) * p.chunk;
  const int c_end = min(c0 + p.chunk, p.hdim);
  const int k_lo = CLUSTER ? c0 : 0;            // the staged hidden columns, over which
  const int k_n = CLUSTER ? c_end - c0 : p.hdim;  // this CTA computes S
  const int ld = (CLUSTER ? p.chunk : p.hdim) + MPAD;
  __nv_bfloat16* s_own = reinterpret_cast<__nv_bfloat16*>(smem4);   // [MB][ld]
  __nv_bfloat16* s_oth = s_own + MB * ld;                           // ST x [OB][ld]
  float* s_part = reinterpret_cast<float*>(s_oth + ST * OB * ld);   // [KQ][MB][PST]
  __nv_bfloat16* s_dl = reinterpret_cast<__nv_bfloat16*>(s_part + KQ * MB * PST);  // [MB][DLD]
  float* s_xs = reinterpret_cast<float*>(s_dl + MB * DLD);         // cluster: 2 x [MB][OB]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kq = warp >> 1, nh = warp & 1;      // S: hidden quarter, 16 other columns
  const int gq = lane >> 2, tq = lane & 3;      // fragment row, column pair
  const int dr = tid >> 3, dc = (tid & 7) * 4;  // dl: own row, 4 other columns
  const int a0 = (blockIdx.x / cl) * MB;
  const int na = DW ? p.v : p.n;
  const int nb = DW ? p.n : p.v;
  const int vecs = k_n / 8;                     // 16-byte pieces a staged row
  const int kw = k_n / KQ;                      // hidden columns a quarter

  const __nv_bfloat16* own = static_cast<const __nv_bfloat16*>(p.own) + k_lo;
  const __nv_bfloat16* other = static_cast<const __nv_bfloat16*>(p.other) + k_lo;

  // rows r0.. of src (rows past `rows` as zeros) -> dst [32][ld], asynchronously
  auto stage = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int r0, int rows) {
    stage_rows<MB, NT>(dst, ld, src, p.hdim, vecs, r0, rows);
  };

  // dh: the dl row is a token, its lse, g and label load once
  float own_lse = 0.f, own_g = 0.f;
  int own_lab = -1;
  if (!DW && a0 + dr < p.n) {
    own_lse = p.lse[a0 + dr];
    own_g = p.g[a0 + dr];
    own_lab = p.labels[a0 + dr];
  }

  float acc[HC][2][2][4];
#pragma unroll
  for (int j = 0; j < HC; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][m][e][q] = 0.f;
  unsigned active = 0;          // pairs inside this chunk (warp-uniform)
#pragma unroll
  for (int j = 0; j < HC; ++j)
    if (c0 + (j * 8 + warp) * 16 < c_end) active |= 1u << j;

  // ldmatrix lane addresses (bytes)
  const unsigned own_a =        // S: A, own rows lane & 15 (+16), hidden quarter kq
      smem_u32(s_own + a_lane(lane, ld) + kq * kw);
  const unsigned dl_a = smem_u32(s_dl + a_lane(lane, DLD));
  const unsigned oth0 = smem_u32(s_oth);
  const unsigned buf_bytes = OB * ld * 2;
  const unsigned oth_s =        // S: B, two n8 tiles of other rows nh * 16 ..
      (nh * 16 * ld + b_lane(lane, ld) + kq * kw) * 2;
  const unsigned oth_p =        // product: B (transposed), other rows = k
      (bt_lane(lane, ld) + c0 - k_lo + warp * 16) * 2;
  const int n_t = (nb + OB - 1) / OB;

  // the buffer that holds other tile t (shared-memory bytes), and this
  // thread's cluster slot of tile t's partial S
  auto buf = [&](int t) { return oth0 + (t % ST) * buf_bytes; };
  auto slot = [&](int t) { return s_xs + ((t & 1) * MB + dr) * OB + dc; };

  // dW: the dl columns of tile t are tokens; their lse, g and label
  struct Tok {
    float lse[4], g[4];
    int lab[4];
  };
  auto tokens = [&](int t) {
    Tok o = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}, {-1, -1, -1, -1}};
    if (DW) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = t * OB + dc + e;
        if (b < p.n) {
          o.lse[e] = p.lse[b];
          o.g[e] = p.g[b];
          o.lab[e] = p.labels[b];
        }
      }
    }
    return o;
  };

  // S[32 own, 16 other of nh] of tile t over hidden quarter kq -> s_part
  auto s_phase = [&](int t) {
    const unsigned ob = buf(t);
    float sacc[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) sacc[m][e][q] = 0.f;
#pragma unroll 2
    for (int k = 0; k < kw; k += 16) {
      unsigned a[2][4], b[4];
      ldsm_x4(own_a + k * 2, a[0]);
      ldsm_x4(own_a + (16 * ld + k) * 2, a[1]);
      ldsm_x4(ob + oth_s + k * 2, b);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(sacc[m][0], a[m], b[0], b[1]);
        mma_bf16(sacc[m][1], a[m], b[2], b[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(s_part + (kq * MB + m * 16 + gq + 8 * i) * PST +
                                     nh * 16 + e * 8 + 2 * tq) =
              make_float2(sacc[m][e][2 * i], sacc[m][e][2 * i + 1]);
  };

  // this CTA's S at (dr, dc .. + 3): the four quarters' partials, in a fixed order
  auto s_sum = [&](float (&s)[4]) {
    float4 part[KQ];
#pragma unroll
    for (int q = 0; q < KQ; ++q)
      part[q] = *reinterpret_cast<const float4*>(s_part + (q * MB + dr) * PST + dc);
    s[0] = (part[0].x + part[1].x) + (part[2].x + part[3].x);
    s[1] = (part[0].y + part[1].y) + (part[2].y + part[3].y);
    s[2] = (part[0].z + part[1].z) + (part[2].z + part[3].z);
    s[3] = (part[0].w + part[1].w) + (part[2].w + part[3].w);
  };

  // dl = (exp(s - lse) - onehot) * g of tile t, rounded to bf16, into [own][other]
  auto dl_phase = [&](int t, const float (&s)[4], const Tok& o) {
    const int a = a0 + dr;
    float d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = t * OB + dc + e;
      const int tok = DW ? b : a, voc = DW ? a : b;
      const float z = DW ? o.lse[e] : own_lse;
      const float gg = DW ? o.g[e] : own_g;
      const int lb = DW ? o.lab[e] : own_lab;
      const float pr = expf(s[e] - z);
      d[e] = (tok < p.n && voc < p.v) ? (pr - (voc == lb ? 1.f : 0.f)) * gg : 0.f;
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(s_dl + dr * DLD + dc);
    dst[0] = __floats2bfloat162_rn(d[0], d[1]);
    dst[1] = __floats2bfloat162_rn(d[2], d[3]);
  };

  // acc[32 own, this warp's columns] += dl[32 own, 32 other] . other tile t
  auto product = [&](int t) {
    const unsigned ob = buf(t);
#pragma unroll
    for (int kk = 0; kk < OB; kk += 16) {
      unsigned a[2][4];
      ldsm_x4(dl_a + kk * 2, a[0]);
      ldsm_x4(dl_a + (16 * DLD + kk) * 2, a[1]);
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        if (active & (1u << j)) {
          unsigned b[4];
          ldsm_x4_t(ob + oth_p + (kk * ld + j * 128) * 2, b);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[j][m][0], a[m], b[0], b[1]);
            mma_bf16(acc[j][m][1], a[m], b[2], b[3]);
          }
        }
      }
    }
  };

  stage(s_own, own, a0, na);
  cp_async_commit();
  if constexpr (ST != 3) {
    // in order: tile t + 1 loads (ST 2) while tile t computes; in a
    // cluster, the partial S meet at a barrier inside each tile
    if (ST == 2) {
      stage(s_oth, other, 0, nb);
      cp_async_commit();
    }
    for (int t = 0; t < n_t; ++t) {
      if (ST == 1) {
        stage(s_oth, other, t * OB, nb);
        cp_async_commit();
      }
      const Tok o = tokens(t);
      cp_async_wait<0>();         // the own tile and tile t have landed
      __syncthreads();            // ... for every thread; tile t - 1 is done with
      if (ST == 2 && t + 1 < n_t) {   // the other buffer, which takes tile t + 1
        stage(s_oth + ((t + 1) % ST) * OB * ld, other, (t + 1) * OB, nb);
        cp_async_commit();
      }
      s_phase(t);
      __syncthreads();
      float s[4];
      s_sum(s);
      if constexpr (CLUSTER) cluster_sum(s, slot(t));
      dl_phase(t, s, o);
      __syncthreads();
      product(t);
      if (ST == 1) __syncthreads();   // the one buffer takes the next tile
    }
    if constexpr (CLUSTER) cluster_arrive();   // peers may still read this CTA's last S
  } else {
    // pipelined, in a cluster (three other buffers): between the barrier's
    // arrive after tile t's partial S and its wait before tile t's dl run
    // the product of tile t - 1 and the S of tile t + 1, while tile t + 2
    // loads
    stage(s_oth, other, 0, nb);
    cp_async_commit();
    if (1 < n_t) stage(s_oth + OB * ld, other, OB, nb);
    cp_async_commit();
    cp_async_wait<1>();           // the own tile and tile 0 have landed
    __syncthreads();
    s_phase(0);
    __syncthreads();
    {
      float s[4];
      s_sum(s);
      float* x = slot(0);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = s[i];
    }
    cluster_arrive();
    for (int t = 0; t < n_t; ++t) {
      const Tok o = tokens(t);
      cp_async_wait<0>();         // tile t + 1 has landed for every thread, and
      __syncthreads();            // every thread is done with tile t - 1's buffer,
      if (t + 2 < n_t) {          // s_part and s_dl
        stage(s_oth + ((t + 2) % 3) * OB * ld, other, (t + 2) * OB, nb);
        cp_async_commit();
      }
      cluster_wait();             // every rank's partial S of tile t is in its slot
      float v[4][4];
      cluster_load(v, slot(t));   // in flight through the S of tile t + 1
      if (t + 1 < n_t) {
        s_phase(t + 1);
        __syncthreads();
      }
      float s[4];
      cluster_gather(s, v, slot(t));
      dl_phase(t, s, o);
      if (t + 1 < n_t) {          // this CTA's partial S of tile t + 1 to its slot
        float s1[4];
        s_sum(s1);
        float* x = slot(t + 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = s1[i];
      }
      cluster_arrive();           // (a CTA barrier too: s_dl is written); the last
      product(t);                 // one keeps this CTA until its peers are done
    }
  }

  store_acc(acc, active, static_cast<TO*>(p.out), a0, na, c0, p.hdim);
  if constexpr (CLUSTER) cluster_wait();
}

// A cluster launch of a backward instance: `kernel` on (own tiles) x
// `cluster` CTAs along x, in clusters of `cluster` that share an own tile,
// with `smem` bytes of dynamic shared memory (the instance's attribute set
// to `smem_max`, its widest slice's). The first launch of the instance at
// each cluster size asks cudaOccupancyMaxActiveClusters whether the card
// can hold one such cluster at `smem_max` and keeps the answer in `fits`;
// where it cannot, cudaErrorLaunchOutOfResources and nothing runs.
constexpr int MAX_CLUSTER = 8;  // CTAs a cluster may portably hold
cudaError_t cluster_launch(void (*kernel)(MmaParams), const MmaParams& p, int na, int smem,
                           int smem_max, int cluster, int (&fits)[MAX_CLUSTER + 1],
                           cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_max);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((na + MB - 1) / MB) * cluster);
  cfg.blockDim = dim3(NT);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (fits[cluster] == 0) {
    cfg.dynamicSmemBytes = smem_max;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
    if (e != cudaSuccess) return e;
    fits[cluster] = clusters > 0 ? 1 : -1;
  }
  if (fits[cluster] < 0) return cudaErrorLaunchOutOfResources;
  cfg.dynamicSmemBytes = smem;
  void* args[] = {const_cast<MmaParams*>(&p)};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool DW, typename TO, int HC, int ST, bool CLUSTER = false>
cudaError_t mma_launch(const MmaParams& p, cudaStream_t st, int cluster = 1) {
  const int smem = mma_smem_bytes(CLUSTER ? p.chunk : p.hdim, ST, CLUSTER);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int na = DW ? p.v : p.n;
  if constexpr (CLUSTER) {
    static int fits[MAX_CLUSTER + 1] = {};
    return cluster_launch(lm_grad_mma_kernel<DW, TO, HC, ST, true>, p, na, smem,
                          mma_smem_bytes(HC * 128, ST, true), cluster, fits, st);
  } else {
    cudaError_t e = cudaFuncSetAttribute(lm_grad_mma_kernel<DW, TO, HC, ST, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((na + MB - 1) / MB, (p.hdim + p.chunk - 1) / p.chunk);
    lm_grad_mma_kernel<DW, TO, HC, ST, false><<<grid, NT, smem, st>>>(p);
    return cudaGetLastError();
  }
}

// the instances: HC 2, 4, 6 double-buffered; HC 6 single-buffered (H > 1152);
// in clusters (H > 1536, slices of 640 or 768 columns) HC 6, pipelined over
// three buffers
template <bool DW, typename TO>
cudaError_t mma_dispatch(const MmaParams& p, int hc, int stages, int cluster, cudaStream_t st) {
  if (cluster > 1)
    return hc == 6 && stages == 3 ? mma_launch<DW, TO, 6, 3, true>(p, st, cluster)
                                  : cudaErrorInvalidValue;
  if (stages == 2) {
    switch (hc) {
      case 2: return mma_launch<DW, TO, 2, 2>(p, st);
      case 4: return mma_launch<DW, TO, 4, 2>(p, st);
      case 6: return mma_launch<DW, TO, 6, 2>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (stages == 1 && hc == 6) return mma_launch<DW, TO, 6, 1>(p, st);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------ 3xTF32 backward (f32 h)

constexpr int OT = 16;          // other rows a staged tile: 2 n8 tiles in S
constexpr int KE = 8;           // hidden eighths of the S product, one a warp
constexpr int TPST = OT + 8;    // row stride of the S partials (f32)
constexpr int TDLD = OT + 4;    // row stride of the f32 dl tile: the product's scalar A
                                // loads, rows gq and columns tq, meet no shared bank

// the resident [32, width] own tile and `stages` [16, width] other tiles
// (width: H, or a cluster's hidden slice), rows padded by 16 bytes; eight
// [32, 24] f32 partials of S; the [32, 20] dl tile; in a cluster, two [32,
// 16] slots of the CTA's partial S
int tf32_smem_bytes(int width, int stages = 2, bool cluster = false) {
  return ((MB + stages * OT) * (width + 4) + KE * MB * TPST + MB * TDLD +
          (cluster ? 2 * MB * OT : 0)) *
         4;
}

// DW = false: dh (own = h rows, other = W rows); DW = true: dW (own = W rows,
// other = h rows); both f32. TO: the output's dtype. HC: the accumulator's
// width in 128-column units, as in lm_grad_mma_kernel. CLUSTER as in
// lm_grad_mma_kernel: false, blockIdx.x an own tile of 32 rows and
// blockIdx.y a hidden chunk; true, the cluster's CTAs share an own tile,
// each its hidden slice, and sum their partial S through distributed shared
// memory. Other tiles of 16 rows go through a cp.async double buffer (ST
// 2), or in a cluster a ring of three (ST 3, pipelined as in
// lm_grad_mma_kernel). S
// phase: warp w computes S[32 own, 16 other] over the hidden eighth w of the
// staged columns; the eight partials meet in shared memory. dl phase:
// thread t owns S[t / 8][(t % 8) * 2 .. + 1]. Product phase: warp w owns the
// pairs of columns c0 + (j * 8 + w) * 16, all 32 own rows. Every product is
// 3xTF32 (mma_sync.cuh), and each short run of it (16 hidden columns of S,
// one tile's 16 other rows of the product) is summed in a fresh accumulator
// and added to the running sum in f32.
template <bool DW, typename TO, int HC, int ST, bool CLUSTER>
__global__ void __launch_bounds__(NT, 1) lm_grad_tf32_kernel(const MmaParams p) {
  using namespace mma_sync;
  extern __shared__ float4 smem4[];
  const int cl = CLUSTER ? static_cast<int>(cluster_nctarank()) : 1;
  const int c0 = (CLUSTER ? static_cast<int>(cluster_ctarank()) : blockIdx.y) * p.chunk;
  const int c_end = min(c0 + p.chunk, p.hdim);
  const int k_lo = CLUSTER ? c0 : 0;            // the staged hidden columns, over which
  const int k_n = CLUSTER ? c_end - c0 : p.hdim;  // this CTA computes S
  const int ld = (CLUSTER ? p.chunk : p.hdim) + 4;
  float* s_own = reinterpret_cast<float*>(smem4);   // [MB][ld]
  float* s_oth = s_own + MB * ld;                   // ST x [OT][ld]
  float* s_part = s_oth + ST * OT * ld;             // [KE][MB][TPST]
  float* s_dl = s_part + KE * MB * TPST;            // [MB][TDLD]
  float* s_xs = s_dl + MB * TDLD;                   // cluster: 2 x [MB][OT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;      // fragment row, column
  const int dr = tid >> 3, dc = (tid & 7) * 2;  // dl: own row, 2 other columns
  const int a0 = (blockIdx.x / cl) * MB;
  const int na = DW ? p.v : p.n;
  const int nb = DW ? p.n : p.v;
  const int vecs = k_n / 4;                     // 16-byte pieces a staged row
  const int kw = k_n / KE;                      // hidden columns an eighth (16k)
  const float* own = static_cast<const float*>(p.own) + k_lo;
  const float* other = static_cast<const float*>(p.other) + k_lo;

  // rows r0 .. r0 + R - 1 of src (rows past `rows` as zeros) -> dst [R][ld],
  // asynchronously: warp w copies rows w, w + 8, .., lane l its 16-byte
  // pieces l, l + 32, .. (no division: rows are a loop, not an index)
  auto stage = [&](float* dst, const float* src, int R, int r0, int rows) {
    for (int r = warp; r < R; r += NT / 32) {
      const bool ok = r0 + r < rows;
      const float* row = src + static_cast<long long>(ok ? r0 + r : 0) * p.hdim;
      const unsigned d = smem_u32(dst + r * ld);
      for (int c = lane; c < vecs; c += 32) cp_async16(d + c * 16, row + c * 4, ok ? 16 : 0);
    }
  };

  // dh: the dl row is a token, its lse, g and label load once
  float own_lse = 0.f, own_g = 0.f;
  int own_lab = -1;
  if (!DW && a0 + dr < p.n) {
    own_lse = p.lse[a0 + dr];
    own_g = p.g[a0 + dr];
    own_lab = p.labels[a0 + dr];
  }

  float acc[HC][2][2][4] = {};
  unsigned active = 0;          // pairs inside this chunk (warp-uniform)
#pragma unroll
  for (int j = 0; j < HC; ++j)
    if (c0 + (j * 8 + warp) * 16 < c_end) active |= 1u << j;

  // ldmatrix lane addresses (bytes) of the S product's TF32 fragments: A,
  // own rows lane & 15 (+16); B, the two n8 tiles of the other tile; both
  // at hidden eighth `warp`
  const unsigned own_a = smem_u32(s_own + a_lane(lane, ld, 4) + warp * kw);
  const unsigned oth_s = (b_lane(lane, ld, 4) + warp * kw) * 4;
  const unsigned oth0 = smem_u32(s_oth);
  const int n_t = (nb + OT - 1) / OT;

  // the buffer that holds other tile t, and this thread's cluster slot of
  // tile t's partial S
  auto buf = [&](int t) { return s_oth + (t % ST) * OT * ld; };
  auto slot = [&](int t) { return s_xs + ((t & 1) * MB + dr) * OT + dc; };

  // dW: the dl columns of tile t are tokens; their lse, g and label
  struct Tok {
    float lse[2], g[2];
    int lab[2];
  };
  auto tokens = [&](int t) {
    Tok o = {{0.f, 0.f}, {0.f, 0.f}, {-1, -1}};
    if (DW) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = t * OT + dc + e;
        if (b < p.n) {
          o.lse[e] = p.lse[b];
          o.g[e] = p.g[b];
          o.lab[e] = p.labels[b];
        }
      }
    }
    return o;
  };

  // S[32 own, 16 other] of tile t over hidden eighth `warp` -> s_part
  auto s_phase = [&](int t) {
    const unsigned ob = oth0 + (t % ST) * OT * ld * 4;
    float sacc[2][2][4] = {};
    for (int k0 = 0; k0 < kw; k0 += 16) {
      float part[2][2][4] = {};
#pragma unroll
      for (int k = k0; k < k0 + 16; k += 8) {
        unsigned a[2][4], b[4];
        ldsm_x4(own_a + k * 4, a[0]);
        ldsm_x4(own_a + (16 * ld + k) * 4, a[1]);
        ldsm_x4(ob + oth_s + k * 4, b);
        unsigned ab[2][4], as[2][4], bb[2][2], bs[2][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          split_tf32(a[0][q], ab[0][q], as[0][q]);
          split_tf32(a[1][q], ab[1][q], as[1][q]);
          split_tf32(b[q], bb[q >> 1][q & 1], bs[q >> 1][q & 1]);
        }
        mma_tf32x3(part, ab, as, bb, bs);
      }
      add_frags(sacc, part);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(s_part + (warp * MB + m * 16 + gq + 8 * i) * TPST + e * 8 +
                                     2 * tq) =
              make_float2(sacc[m][e][2 * i], sacc[m][e][2 * i + 1]);
  };

  // this CTA's S at (dr, dc .. + 1): the eight eighths' partials, in a fixed order
  auto s_sum = [&](float (&s)[2]) {
    float2 q8[KE];
#pragma unroll
    for (int q = 0; q < KE; ++q)
      q8[q] = *reinterpret_cast<const float2*>(s_part + (q * MB + dr) * TPST + dc);
    s[0] = ((q8[0].x + q8[1].x) + (q8[2].x + q8[3].x)) +
           ((q8[4].x + q8[5].x) + (q8[6].x + q8[7].x));
    s[1] = ((q8[0].y + q8[1].y) + (q8[2].y + q8[3].y)) +
           ((q8[4].y + q8[5].y) + (q8[6].y + q8[7].y));
  };

  // dl = (exp(s - lse) - onehot) * g of tile t in f32, into [own][other]
  auto dl_phase = [&](int t, const float (&s)[2], const Tok& o) {
    const int a = a0 + dr;
    float d[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = t * OT + dc + e;
      const int tok = DW ? b : a, voc = DW ? a : b;
      const float z = DW ? o.lse[e] : own_lse;
      const float gg = DW ? o.g[e] : own_g;
      const int lb = DW ? o.lab[e] : own_lab;
      const float pr = expf(s[e] - z);
      d[e] = (tok < p.n && voc < p.v) ? (pr - (voc == lb ? 1.f : 0.f)) * gg : 0.f;
    }
    *reinterpret_cast<float2*>(s_dl + dr * TDLD + dc) = make_float2(d[0], d[1]);
  };

  // acc[32 own, this warp's columns] += dl[32 own, 16 other] . other tile t,
  // two k8 steps. The B fragments are scalar loads other[k][n + gq] (the tile
  // is k-major here); at a row stride of 4 banks two lanes share a bank.
  // Permuting k so that none does (rows 2tq, 2tq + 1, A pairs as float2)
  // measured 7% slower (PERF.md), so the fragments keep their own order.
  auto product = [&](int t) {
    unsigned ab[2][2][4], as[2][2][4];   // [k8 step][m]
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i) {    // rows gq and gq + 8: (a0, a2), (a1, a3)
          const float* row = s_dl + (m * 16 + gq + 8 * i) * TDLD + ks * 8;
          split_tf32(__float_as_uint(row[tq]), ab[ks][m][i], as[ks][m][i]);
          split_tf32(__float_as_uint(row[tq + 4]), ab[ks][m][i + 2], as[ks][m][i + 2]);
        }
    const float* ot = buf(t) + c0 - k_lo + warp * 16 + gq;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      if (active & (1u << j)) {
        float part[2][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          unsigned bb[2][2], bs[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              split_tf32(__float_as_uint(ot[(ks * 8 + tq + 4 * q) * ld + j * 128 + e * 8]),
                         bb[e][q], bs[e][q]);
          mma_tf32x3(part, ab[ks], as[ks], bb, bs);
        }
        add_frags(acc[j], part);
      }
    }
  };

  stage(s_own, own, MB, a0, na);
  cp_async_commit();
  stage(s_oth, other, OT, 0, nb);
  cp_async_commit();
  if constexpr (ST == 2) {
    // in order: tile t + 1 loads while tile t computes; in a cluster, the
    // partial S meet at a barrier inside each tile
    for (int t = 0; t < n_t; ++t) {
      const Tok o = tokens(t);
      cp_async_wait<0>();         // the own tile and tile t have landed
      __syncthreads();            // ... for every thread; tile t - 1 is done with
      if (t + 1 < n_t) {          // the other buffer, which takes tile t + 1
        stage(buf(t + 1), other, OT, (t + 1) * OT, nb);
        cp_async_commit();
      }
      s_phase(t);
      __syncthreads();
      float s[2];
      s_sum(s);
      if constexpr (CLUSTER) cluster_sum(s, slot(t));
      dl_phase(t, s, o);
      __syncthreads();
      product(t);
    }
    if constexpr (CLUSTER) cluster_arrive();   // peers may still read this CTA's last S
  } else {
    // pipelined, in a cluster (three other buffers): between the barrier's
    // arrive after tile t's partial S and its wait before tile t's dl run
    // the product of tile t - 1 and the S of tile t + 1, while tile t + 2
    // loads
    if (1 < n_t) stage(buf(1), other, OT, OT, nb);
    cp_async_commit();
    cp_async_wait<1>();           // the own tile and tile 0 have landed
    __syncthreads();
    s_phase(0);
    __syncthreads();
    {
      float s[2];
      s_sum(s);
      float* x = slot(0);
      x[0] = s[0];
      x[1] = s[1];
    }
    cluster_arrive();
    for (int t = 0; t < n_t; ++t) {
      const Tok o = tokens(t);
      cp_async_wait<0>();         // tile t + 1 has landed for every thread, and
      __syncthreads();            // every thread is done with tile t - 1's buffer,
      if (t + 2 < n_t) {          // s_part and s_dl
        stage(buf(t + 2), other, OT, (t + 2) * OT, nb);
        cp_async_commit();
      }
      cluster_wait();             // every rank's partial S of tile t is in its slot
      float v[4][2];
      cluster_load(v, slot(t));   // in flight through the S of tile t + 1
      if (t + 1 < n_t) {
        s_phase(t + 1);
        __syncthreads();
      }
      float s[2];
      cluster_gather(s, v, slot(t));
      dl_phase(t, s, o);
      if (t + 1 < n_t) {          // this CTA's partial S of tile t + 1 to its slot
        float s1[2];
        s_sum(s1);
        float* x = slot(t + 1);
        x[0] = s1[0];
        x[1] = s1[1];
      }
      cluster_arrive();           // (a CTA barrier too: s_dl is written); the last
      product(t);                 // one keeps this CTA until its peers are done
    }
  }

  store_acc(acc, active, static_cast<TO*>(p.out), a0, na, c0, p.hdim);
  if constexpr (CLUSTER) cluster_wait();
}

template <bool DW, typename TO, int HC, int ST = 2, bool CLUSTER = false>
cudaError_t tf32_launch(const MmaParams& p, cudaStream_t st, int cluster = 1) {
  const int smem = tf32_smem_bytes(CLUSTER ? p.chunk : p.hdim, ST, CLUSTER);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int na = DW ? p.v : p.n;
  if constexpr (CLUSTER) {
    static int fits[MAX_CLUSTER + 1] = {};
    return cluster_launch(lm_grad_tf32_kernel<DW, TO, HC, ST, true>, p, na, smem,
                          tf32_smem_bytes(HC * 128, ST, true), cluster, fits, st);
  } else {
    cudaError_t e = cudaFuncSetAttribute(lm_grad_tf32_kernel<DW, TO, HC, ST, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((na + MB - 1) / MB, (p.hdim + p.chunk - 1) / p.chunk);
    lm_grad_tf32_kernel<DW, TO, HC, ST, false><<<grid, NT, smem, st>>>(p);
    return cudaGetLastError();
  }
}

// the instances: HC 2, 4, 6, double-buffered (H <= 768 fits); in clusters
// (H > 768) HC 4 pipelined over three buffers (slices of 384 or 512
// columns, H <= 4096) and HC 6 double-buffered in order (slices of 640 or
// 768, H > 4096, where three buffers do not fit)
template <bool DW, typename TO>
cudaError_t tf32_dispatch(const MmaParams& p, int hc, int stages, int cluster, cudaStream_t st) {
  if (cluster > 1) {
    if (hc == 4 && stages == 3) return tf32_launch<DW, TO, 4, 3, true>(p, st, cluster);
    if (hc == 6 && stages == 2) return tf32_launch<DW, TO, 6, 2, true>(p, st, cluster);
    return cudaErrorInvalidValue;
  }
  if (stages != 2) return cudaErrorInvalidValue;
  switch (hc) {
    case 2: return tf32_launch<DW, TO, 2>(p, st);
    case 4: return tf32_launch<DW, TO, 4>(p, st);
    case 6: return tf32_launch<DW, TO, 6>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// The FMA forward kernels, one per (h dtype, W dtype): the predecessor of
// the tensor-core forwards, timed beside them at either dtype of h. Plain
// functions rather than template instances, so that their names read
// plainly in ptxas's report.
#define LM_FWD_KERNEL(NAME, TH, TW)                                          \
  __global__ void __launch_bounds__(NT) NAME(const FwdParams p) {            \
    fwd_body<TH, TW>(p);                                                     \
  }
LM_FWD_KERNEL(lm_fwd_full_f32_f32, float, float)
LM_FWD_KERNEL(lm_fwd_full_f32_bf16, float, __nv_bfloat16)
LM_FWD_KERNEL(lm_fwd_full_bf16_f32, __nv_bfloat16, float)
LM_FWD_KERNEL(lm_fwd_full_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
#undef LM_FWD_KERNEL

// ------------------------------------------------------ tensor-core forward

constexpr int FM = 128;        // h rows a CTA: 4 warp rows of 32
constexpr int FN = 128;        // W rows (vocab columns) a tile: 2 warp columns of 64
constexpr int FSTAGES = 3;
// a stage: 128 bytes of each row (64 bf16 or 32 f32 hidden columns) and a
// 16-byte pad, in either dtype 110,592 bytes
constexpr int FWD_MMA_SMEM = FSTAGES * (FM + FN) * (128 + 16);
constexpr int FWD_MMA_CTAS = 2112;  // 8 waves of 2 CTAs (16 of 1) on each of 132 SMs

struct FwdMmaParams {
  const void* h;            // [n, hdim], bf16 or f32
  const void* w;            // [v, hdim], h's dtype
  const int* labels;        // [n]
  float* part;              // [3][splits][n]: m, l, picked
  int n, v, hdim;
  int v_true;               // columns >= v_true are masked to NEG_INF (MASK)
};

// One CTA: 128 rows of h against the vocab tiles blockIdx.y, +gridDim.y, ...
// as one stream of [128, 64] h and W slices through a FSTAGES-deep cp.async
// ring (the next tile's slices load while a tile's epilogue runs). Warp
// (wm, wn) = (warp / 2, warp % 2) computes S[32 rows wm, 64 columns wn] of
// the tile. After a tile's last slice, each thread folds its 16 values of
// each of its 4 rows into its own running (m, l) in log2 units (no shuffles
// a tile), and picks the label's logit when the label falls in its columns.
// At the end the partials merge over the quad, then over the two warp
// columns in shared memory, in a fixed order. PICK: the label's logit;
// MASK: columns >= v_true masked. Columns past v never count.
// T: h's and W's dtype. bf16: mma.sync.m16n8k16; a stage holds 64 hidden
// columns, 4 k16 steps of 2 A and 4 B ldmatrix and 16 mma. f32 (3xTF32):
// mma.sync.m16n8k8 .tf32; a stage holds 32 hidden columns (the same 128
// bytes a row), 4 k8 steps of 2 A and 4 B ldmatrix (an f32 tile's 8 x 4
// blocks are ldmatrix's 8 x 8 b16 blocks), each value split into its TF32
// big and small parts where it is loaded (24 values), and 48 mma. Each
// slice is summed in a fresh accumulator and added to S in f32: the tensor
// core truncates as it accumulates, and one accumulator across the hidden
// loop (3 H / 8 products into each) drifted enough to move the loss by
// 1.3e-5 at H = 768 (PERF.md).
template <typename T, bool PICK, bool MASK>
__device__ __forceinline__ void fwd_mma_body(const FwdMmaParams& p) {
  using namespace mma_sync;
  constexpr bool TF32 = std::is_same<T, float>::value;
  constexpr int V = 16 / sizeof(T);      // elements in 16 bytes
  constexpr int FK = 8 * V;              // hidden columns a stage (128 bytes)
  constexpr int FLD = FK + V;            // row stride of a staged slice
  extern __shared__ float4 smem4[];
  __shared__ float red[2][3][FM];  // (m, l, picked) of each warp column
  T* ring = reinterpret_cast<T*>(smem4);  // FSTAGES x [FM + FN][FLD]
  const T* h = static_cast<const T*>(p.h);
  const T* w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * FM;
  const int n_vt = (p.v + FN - 1) / FN;
  const int tiles = blockIdx.y < n_vt ? (n_vt - 1 - blockIdx.y) / gridDim.y + 1 : 0;
  const int nk = p.hdim / FK;
  const int total = tiles * nk;   // slices this CTA streams

  // slice g (tile g / nk, hidden columns (g % nk) * FK ..) into its buffer;
  // rows past n or v as zeros
  auto stage = [&](int g) {
    const int t = g / nk, kc = (g - t * nk) * FK;
    const int v0 = (blockIdx.y + t * gridDim.y) * FN;
    T* dst = ring + (g % FSTAGES) * (FM + FN) * FLD;
#pragma unroll
    for (int i = 0; i < (FM + FN) * FK / V / NT; ++i) {   // 8 pieces of 16 bytes a thread
      const int idx = tid + i * NT;
      const int r = idx >> 3, c = (idx & 7) * V;
      const bool is_h = r < FM;
      const int row = is_h ? r0 + r : v0 + r - FM;
      const bool ok = row < (is_h ? p.n : p.v);
      const T* src = (is_h ? h : w) + static_cast<long long>(ok ? row : 0) * p.hdim + kc + c;
      cp_async16(smem_u32(dst + r * FLD + c), src, ok ? 16 : 0);
    }
  };

  // this thread's rows: ri = mt * 2 + i is row wm * 32 + mt * 16 + gq + 8 * i
  int lab[4];
  float m[4], l[4], pk[4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int r = r0 + wm * 32 + (ri >> 1) * 16 + gq + 8 * (ri & 1);
    lab[ri] = (PICK && r < p.n) ? p.labels[r] : -1;
    m[ri] = NEG_INF;
    l[ri] = 0.f;
    pk[ri] = 0.f;
  }
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // ldmatrix lane offsets (elements) inside a stage
  const int a_off = wm * 32 * FLD + a_lane(lane, FLD, V);
  const int b_off = (FM + wn * 64) * FLD + b_lane(lane, FLD, V);

#pragma unroll
  for (int g = 0; g < FSTAGES - 1; ++g) {
    if (g < total) stage(g);
    cp_async_commit();
  }
  for (int g = 0; g < total; ++g) {
    cp_async_wait<FSTAGES - 2>();   // slice g has landed ...
    __syncthreads();                // ... for every thread; slice g - 1's buffer is free
    if (g + FSTAGES - 1 < total) stage(g + FSTAGES - 1);
    cp_async_commit();
    const unsigned buf = smem_u32(ring + (g % FSTAGES) * (FM + FN) * FLD);
    if constexpr (!TF32) {
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk) {
        unsigned a[2][4];
        ldsm_x4(buf + (a_off + kk * 16) * 2, a[0]);
        ldsm_x4(buf + (a_off + 16 * FLD + kk * 16) * 2, a[1]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned b[4];
          ldsm_x4(buf + (b_off + np * 16 * FLD + kk * 16) * 2, b);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
    } else {
      float run[2][8][4] = {};   // the slice's products, a fresh accumulator
#pragma unroll
      for (int kk = 0; kk < FK / 8; ++kk) {
        unsigned a[2][4], ab[2][4], as[2][4], bb[8][2], bs[8][2];
        ldsm_x4(buf + (a_off + kk * 8) * 4, a[0]);
        ldsm_x4(buf + (a_off + 16 * FLD + kk * 8) * 4, a[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int x = 0; x < 4; ++x) split_tf32(a[mt][x], ab[mt][x], as[mt][x]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned b[4];
          ldsm_x4(buf + (b_off + np * 16 * FLD + kk * 8) * 4, b);
#pragma unroll
          for (int x = 0; x < 4; ++x)
            split_tf32(b[x], bb[2 * np + (x >> 1)][x & 1], bs[2 * np + (x >> 1)][x & 1]);
        }
        mma_tf32x3(run, ab, as, bb, bs);
      }
      add_frags(acc, run);
    }
    if ((g + 1) % nk) continue;

    // the tile's epilogue: acc[mt][j][2i + e] is row ri = 2mt + i, column
    // c0 + j * 8 + e
    const int v0 = (blockIdx.y + (g / nk) * gridDim.y) * FN;
    const int c0 = v0 + wn * 64 + 2 * tq;
    const bool edge = v0 + FN > p.v || (MASK && v0 + FN > p.v_true);
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int mt = ri >> 1, i = ri & 1;
      float x2[16];
      float mx = m[ri];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + j * 8 + e;
          float x = acc[mt][j][2 * i + e];
          if (MASK && edge && col >= p.v_true) x = NEG_INF;
          // the label's logit, compared element by element: a select
          // indexed by the label would put acc in local memory
          if (PICK && col == lab[ri] && col < p.v) pk[ri] += x;
          if (edge && col >= p.v) x = -INFINITY;  // not a column: adds exactly 0
          x2[j * 2 + e] = x * LOG2E;
          mx = fmaxf(mx, x2[j * 2 + e]);
        }
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) rs += exp2_approx(x2[c] - mx);
      l[ri] = l[ri] * exp2_approx(m[ri] - mx) + rs;
      m[ri] = mx;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  }

  // merge the partials: over the quad (lanes tq share a row; both lanes of a
  // pair compute the same bits), then over the two warp columns
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[ri], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[ri], off);
      const float po = __shfl_xor_sync(0xffffffffu, pk[ri], off);
      const float mx = fmaxf(m[ri], mo);
      l[ri] = l[ri] * exp2_approx(m[ri] - mx) + lo * exp2_approx(mo - mx);
      m[ri] = mx;
      pk[ri] += po;
    }
    if (tq == 0) {
      const int r = wm * 32 + (ri >> 1) * 16 + gq + 8 * (ri & 1);
      red[wn][0][r] = m[ri];
      red[wn][1][r] = l[ri];
      red[wn][2][r] = pk[ri];
    }
  }
  __syncthreads();
  if (tid < FM && r0 + tid < p.n) {
    const float m0 = red[0][0][tid], m1 = red[1][0][tid];
    const float mx = fmaxf(m0, m1);
    const float lsum =
        red[0][1][tid] * exp2_approx(m0 - mx) + red[1][1][tid] * exp2_approx(m1 - mx);
    const long long plane = static_cast<long long>(gridDim.y) * p.n;
    const long long o = static_cast<long long>(blockIdx.y) * p.n + r0 + tid;
    p.part[o] = mx * LN2;   // back to natural units for the merge kernel
    p.part[plane + o] = lsum;
    p.part[2 * plane + o] = red[0][2][tid] + red[1][2][tid];
  }
}

cudaError_t merge_launch(const float* part, int splits, int n, void* loss, void* lse,
                         cudaStream_t st) {
  lm_merge_kernel<<<(n + NT - 1) / NT, NT, 0, st>>>(part, splits, n, static_cast<float*>(loss),
                                                    static_cast<float*>(lse));
  return cudaGetLastError();
}

// The tensor-core forward's instances: `full` is the public one (label pick
// and masking at v_true); `bare` (product and online logsumexp only) and
// `picked` (plus the label pick) are the compile probe's stripped variants.
#define LM_FWD_MMA_KERNEL(NAME, PICK, MASK)                                   \
  __global__ void __launch_bounds__(NT, 2) NAME(const FwdMmaParams p) {       \
    fwd_mma_body<__nv_bfloat16, PICK, MASK>(p);                               \
  }
LM_FWD_MMA_KERNEL(lm_fwd_mma_full, true, true)
LM_FWD_MMA_KERNEL(lm_fwd_mma_bare, false, false)
LM_FWD_MMA_KERNEL(lm_fwd_mma_picked, true, false)
#undef LM_FWD_MMA_KERNEL

// The 3xTF32 forward (the route for f32 h): one CTA an SM, since the
// slice's fresh accumulator and the split fragments (64 + 48 registers)
// beside the running S (64) do not fit in the 128 registers a thread that
// two CTAs an SM would leave
__global__ void __launch_bounds__(NT, 1) lm_fwd_tf32_full(const FwdMmaParams p) {
  fwd_mma_body<float, true, true>(p);
}

// the tensor-core forward `kernel` on h, w with 16-byte aligned rows (vec
// elements in 16 bytes), then the merge of its vocab splits
cudaError_t fwd_tc_launch(void (*kernel)(const FwdMmaParams), const void* h, const void* w,
                          const void* labels, void* loss, void* lse, void* part, int n, int v,
                          int hdim, int v_true, int splits, int vec, cudaStream_t st) {
  if (!shape_ok(n, v, hdim) || splits < 1 || !mma_sync::aligned16(h, {hdim}, vec) ||
      !mma_sync::aligned16(w, {hdim}, vec))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       FWD_MMA_SMEM);
  if (e != cudaSuccess) return e;
  FwdMmaParams p;
  p.h = h;
  p.w = w;
  p.labels = static_cast<const int*>(labels);
  p.part = static_cast<float*>(part);
  p.n = n; p.v = v; p.hdim = hdim; p.v_true = v_true;
  kernel<<<dim3((n + FM - 1) / FM, splits), NT, FWD_MMA_SMEM, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return merge_launch(p.part, splits, n, loss, lse, st);
}

}  // namespace

// The number of CTAs that share each 32-row tile's vocab in the FMA forward
// (a function of the shapes only, so results are deterministic): about 1056
// CTAs in all, 8 a SM.
extern "C" int lm_loss_fwd_splits(int n, int v) {
  const int row_tiles = (n + BA - 1) / BA;
  const int vocab_tiles = (v + BB - 1) / BB;
  const int s = (1056 + row_tiles - 1) / row_tiles;
  return s < 1 ? 1 : (s < vocab_tiles ? s : vocab_tiles);
}

// The FMA forward. h: [n, hdim], w: [v, hdim] contiguous (dtype 0 = float32,
// 1 = bfloat16, each its own); labels: [n] int32; loss, lse: [n] f32 out;
// part: [3, splits, n] f32 scratch with splits = lm_loss_fwd_splits(n, v).
// Columns >= v_true are masked. hdim a multiple of 128. Launches the split
// forward and the merge; returns cudaGetLastError().
extern "C" int lm_loss_fwd(const void* h, const void* w, const void* labels, void* loss,
                           void* lse, void* part, int htype, int wtype, int n, int v, int hdim,
                           int v_true, int splits, void* stream) {
  if (!shape_ok(n, v, hdim) || splits < 1 || htype < 0 || htype > 1 || wtype < 0 || wtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const FwdParams) =
      htype == 0 ? (wtype == 0 ? lm_fwd_full_f32_f32 : lm_fwd_full_f32_bf16)
                 : (wtype == 0 ? lm_fwd_full_bf16_f32 : lm_fwd_full_bf16_bf16);
  FwdParams p;
  p.h = h; p.w = w;
  p.labels = static_cast<const int*>(labels);
  p.part = static_cast<float*>(part);
  p.n = n; p.v = v; p.hdim = hdim; p.v_true = v_true;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3((n + BA - 1) / BA, splits), NT, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(merge_launch(p.part, splits, n, loss, lse, st));
}

// The number of CTAs that share each 128-row tile's vocab in the
// tensor-core forward (a function of the shapes only): FWD_MMA_CTAS in all,
// at most one a vocab tile.
extern "C" int lm_loss_fwd_mma_splits(int n, int v) {
  const int row_tiles = (n + FM - 1) / FM;
  const int vocab_tiles = (v + FN - 1) / FN;
  const int s = (FWD_MMA_CTAS + row_tiles - 1) / row_tiles;
  return s < 1 ? 1 : (s < vocab_tiles ? s : vocab_tiles);
}

// The tensor-core forward: h [n, hdim] and w [v, hdim] both bf16 (the
// wrapper casts an f32 W once a call), contiguous and 16-byte aligned; hdim a
// multiple of 128. Other arguments as lm_loss_fwd, with splits =
// lm_loss_fwd_mma_splits(n, v); variant 0 = full, 1 = bare, 2 = picked (the
// compile probe's). Returns cudaGetLastError().
extern "C" int lm_loss_fwd_mma(const void* h, const void* w, const void* labels, void* loss,
                               void* lse, void* part, int n, int v, int hdim, int v_true,
                               int splits, int variant, void* stream) {
  void (*kernel)(const FwdMmaParams) = variant == 0   ? lm_fwd_mma_full
                                       : variant == 1 ? lm_fwd_mma_bare
                                       : variant == 2 ? lm_fwd_mma_picked
                                                      : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd_tc_launch(kernel, h, w, labels, loss, lse, part, n, v, hdim,
                                        v_true, splits, 8, static_cast<cudaStream_t>(stream)));
}

// The 3xTF32 forward: h [n, hdim] and w [v, hdim] both f32 (the wrapper
// casts a bf16 W once a call, exactly), contiguous and 16-byte aligned; the
// other arguments as lm_loss_fwd_mma's, with the same splits. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for operands it does not
// take.
extern "C" int lm_loss_fwd_tf32(const void* h, const void* w, const void* labels, void* loss,
                                void* lse, void* part, int n, int v, int hdim, int v_true,
                                int splits, void* stream) {
  return static_cast<int>(fwd_tc_launch(lm_fwd_tf32_full, h, w, labels, loss, lse, part, n, v,
                                        hdim, v_true, splits, 4,
                                        static_cast<cudaStream_t>(stream)));
}

// dh (dw = 0: out [n, hdim] in h's dtype) or dW (dw = 1: out [v, hdim] in
// W's dtype) of the loss, from the forward's lse and the loss cotangent g
// ([n] f32). Other arguments as lm_loss_fwd. Returns cudaGetLastError().
extern "C" int lm_loss_bwd(const void* h, const void* w, const void* labels, const void* lse,
                           const void* g, void* out, int htype, int wtype, int n, int v,
                           int hdim, int dw, void* stream) {
  if (!shape_ok(n, v, hdim)) return static_cast<int>(cudaErrorInvalidValue);
  GradParams p;
  p.h = h; p.w = w;
  p.labels = static_cast<const int*>(labels);
  p.lse = static_cast<const float*>(lse);
  p.g = static_cast<const float*>(g);
  p.out = out;
  p.n = n; p.v = v; p.hdim = hdim; p.chunk = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (htype == 0 && wtype == 0) e = grad_which<float, float>(p, dw, st);
  else if (htype == 0 && wtype == 1) e = grad_which<float, __nv_bfloat16>(p, dw, st);
  else if (htype == 1 && wtype == 0) e = grad_which<__nv_bfloat16, float>(p, dw, st);
  else if (htype == 1 && wtype == 1) e = grad_which<__nv_bfloat16, __nv_bfloat16>(p, dw, st);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The tensor-core dh (dw = 0: out [n, hdim] in itype) or dW (dw = 1: out [v,
// hdim] in otype) of the loss; dtype codes 0 = float32, 1 = bfloat16. h and
// w are both of itype, contiguous and 16-byte aligned (the wrapper casts a W
// of the other dtype once): bf16 on the bf16 tensor cores, f32 in 3xTF32.
// The output dtype is given apart from the dtype read, since dW comes out
// in the master W's. The plan comes from lm_loss.py's backward_plan: chunk,
// the hidden columns a CTA accumulates (a multiple of 128); hc, the
// accumulator instance, 2, 4 or 6 with chunk <= hc * 128; stages, the
// other-tile buffers, 1 or 2, or 3 (a cluster's pipelined instances);
// cluster, 1 (the hidden chunks over gridDim.y, each CTA computing S over
// the full H) or 2..8 CTAs of a thread-block cluster that split the hidden
// dim into slices of chunk columns (chunk * (cluster - 1) < hdim <= chunk *
// cluster). Returns cudaGetLastError(); cudaErrorInvalidValue for a plan
// without an instance or beyond the shared memory;
// cudaErrorLaunchOutOfResources where the card cannot hold such a cluster.
extern "C" int lm_loss_bwd_mma(const void* h, const void* w, const void* labels,
                               const void* lse, const void* g, void* out, int itype, int otype,
                               int n, int v, int hdim, int dw, int chunk, int hc, int stages,
                               int cluster, void* stream) {
  if (!shape_ok(n, v, hdim) || chunk <= 0 || chunk % 128 || chunk > hc * 128 || itype < 0 ||
      itype > 1 || otype < 0 || otype > 1 || (!dw && otype != itype) ||
      !mma_sync::aligned16(h, {hdim}) || !mma_sync::aligned16(w, {hdim}) || cluster < 1 ||
      cluster > MAX_CLUSTER ||
      (cluster > 1 && (chunk * (cluster - 1) >= hdim || chunk * cluster < hdim)))
    return static_cast<int>(cudaErrorInvalidValue);
  MmaParams p;
  p.own = dw ? w : h;
  p.other = dw ? h : w;
  p.labels = static_cast<const int*>(labels);
  p.lse = static_cast<const float*>(lse);
  p.g = static_cast<const float*>(g);
  p.out = out;
  p.n = n; p.v = v; p.hdim = hdim; p.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (itype == 1) {
    if (!dw) e = mma_dispatch<false, __nv_bfloat16>(p, hc, stages, cluster, st);
    else if (otype == 0) e = mma_dispatch<true, float>(p, hc, stages, cluster, st);
    else e = mma_dispatch<true, __nv_bfloat16>(p, hc, stages, cluster, st);
  } else {
    if (!dw) e = tf32_dispatch<false, float>(p, hc, stages, cluster, st);
    else if (otype == 0) e = tf32_dispatch<true, float>(p, hc, stages, cluster, st);
    else e = tf32_dispatch<true, __nv_bfloat16>(p, hc, stages, cluster, st);
  }
  return static_cast<int>(e);
}
