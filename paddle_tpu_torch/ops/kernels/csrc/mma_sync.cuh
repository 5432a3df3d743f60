// Building blocks of the tensor-core kernels (sm_90a), shared by
// flash_attention_fwd.cu, flash_attention_bwd.cu and lm_loss.cu: cp.async
// copies into shared memory and the tile stager built on them, ldmatrix
// loads of 8 x 8 bf16 blocks and their lane offsets, the bf16
// mma.sync.m16n8k16 product with f32 accumulation, the TF32
// mma.sync.m16n8k8 product and its error-compensated 3xTF32 form (f32
// operands at f32 accuracy), the MUFU exp2, a warp's 16-row bf16 epilogue,
// the flash kernels' 3xTF32 accumulator, product and f32 epilogue, the
// thread-block cluster's rank, barrier and rank-ordered sum through
// distributed shared memory, and the host's alignment check of a staged
// operand.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * gq + tq):
//   A (16 x 16, row): a0 = (row gq, k 2tq..+1), a1 = (gq + 8, 2tq..+1),
//                     a2 = (gq, 2tq + 8..+9), a3 = (gq + 8, 2tq + 8..+9);
//   B (16 x 8, col):  b0 = (k 2tq..+1, col gq), b1 = (k 2tq + 8..+9, col gq);
//   C (16 x 8, f32):  c0, c1 = (row gq, cols 2tq, 2tq + 1), c2, c3 = row gq + 8.
// ldmatrix.x4 with lane l addressing row (l & 15), column (l >> 4) * 8 of a
// row-major [m][k] tile gives a0..a3; with lane l addressing row
// (l >> 4) * 8 + (l & 7), column ((l >> 3) & 1) * 8 of a row-major [n][k] tile
// gives b0, b1 of two n8 tiles; ldmatrix.x4.trans with lane l addressing row
// (l & 7) + ((l >> 3) & 1) * 8, column (l >> 4) * 8 of a row-major [k][n] tile
// does the same for a B stored k-major. An f32 C fragment of two n8 tiles
// (cols 16j..16j+15) packs into the A fragment of k step j: a0 = c[2j][0..1],
// a1 = c[2j][2..3], a2 = c[2j + 1][0..1], a3 = c[2j + 1][2..3].
//
// Fragment layout of mma.sync.m16n8k8 with .tf32 operands (one f32 value a
// register, its low 13 bits ignored):
//   A (16 x 8, row):  a0 = (row gq, k tq), a1 = (gq + 8, tq), a2 = (gq, tq + 4),
//                     a3 = (gq + 8, tq + 4);
//   B (8 x 8, col):   b0 = (k tq, col gq), b1 = (k tq + 4, col gq);
//   C (16 x 8, f32):  as m16n8k16's.
// ldmatrix.x4 (b16) reads an 8 x 4 block of a row-major f32 tile as an 8 x 8
// b16 block (lane l gets word l & 3 of row l >> 2), so the same lane offsets
// with 4 f32 (16 bytes) in place of 8 bf16 give the TF32 fragments:
// a_lane(lane, ld, 4) on a row-major [m][k] tile gives a0..a3, b_lane(lane,
// ld, 4) on a row-major [n][k] tile b0, b1 of two n8 tiles (registers 0, 1
// and 2, 3). ldmatrix.trans moves 16-bit elements only, so a B stored k-major
// ([k][n] f32) takes scalar 32-bit loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace mma_sync {

// a staged bf16 row's padding: 8 elements (16 bytes), so the eight rows an
// ldmatrix reads start in different shared-memory banks
constexpr int MPAD = 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
// 4 bytes global -> shared (through L1); src_bytes = 0 writes 4 zero bytes
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a . b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a . b: a 16 x 8 tf32 (row), b 8 x 8 tf32 (col), d 16 x 8 f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x (finite f32 bits) = big + small as TF32 operands. big = x's bits plus
// 0x1000: the tensor core reads the top 19 bits only, so it takes big as x
// rounded to TF32 (10 mantissa bits, to nearest, ties away: the value of
// cvt.rna.tf32.f32, which ptxas compiles to this add guarded against inf and
// NaN). small = x - big rounded, exactly (|small| <= 2^-11 |x|); the tensor
// core drops its low 13 bits, so big + small holds x to 2^-21 of |x|. Three
// instructions a value, where two cvt.rna and the subtraction take seven
// (big = x as it is, truncated, saves the add but measured slower in
// lm_loss.cu's 3xTF32 backward).
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& big, unsigned& small) {
  big = x + 0x1000u;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big & 0xffffe000u));
}
// d[i][j] += a[i] . b[j] for M A fragments and N n8 B fragments (b[j] =
// {b0, b1}), one TF32 pass
template <int M, int N>
__device__ __forceinline__ void mma_tf32_all(float (&d)[M][N][4], const unsigned (&a)[M][4],
                                             const unsigned (&b)[N][2]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[i][j], a[i], b[j][0], b[j][1]);
}
// the same product at f32 accuracy from split operands (3xTF32): the two
// small terms first, then big . big; a_small . b_small (~2^-22 of the
// product) is left out. Pass-major, so that M x N independent products
// stand between two that share an accumulator.
template <int M, int N>
__device__ __forceinline__ void mma_tf32x3(float (&d)[M][N][4], const unsigned (&a_big)[M][4],
                                           const unsigned (&a_small)[M][4],
                                           const unsigned (&b_big)[N][2],
                                           const unsigned (&b_small)[N][2]) {
  mma_tf32_all(d, a_small, b_big);
  mma_tf32_all(d, a_big, b_small);
  mma_tf32_all(d, a_big, b_big);
}
// d += s over M x N C fragments, in f32 (round to nearest): a sum of many
// products kept in one tensor-core accumulator drifts, since the tensor core
// truncates as it accumulates; a kernel sums a few products in a fresh
// accumulator and adds it here
template <int M, int N>
__device__ __forceinline__ void add_frags(float (&d)[M][N][4], const float (&s)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) d[i][j][q] += s[i][j][q];
}
// two floats rounded to bf16 (nearest even) in one register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&t);
}
// 2^x on the MUFU (ex2.approx, 2 ulp; -inf and very negative x give 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ldmatrix.x4 lane offsets (elements) in a row-major tile of row stride ld,
// as the fragment layout above has them: the A fragment of rows 0..15 of an
// [m][k] tile; the B fragments of two n8 tiles (rows 0..15) of an [n][k]
// tile; the same of a [k][n] tile through ldsm_x4_t. v: elements in 16
// bytes (8 bf16; 4 f32 for the TF32 fragments)
__device__ __forceinline__ int a_lane(int lane, int ld, int v = 8) {
  return (lane & 15) * ld + (lane >> 4) * v;
}
__device__ __forceinline__ int b_lane(int lane, int ld, int v = 8) {
  return ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * v;
}
__device__ __forceinline__ int bt_lane(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

// rows r0 .. r0 + ROWS - 1 of a bf16 or f32 operand of `vecs` 16-byte pieces
// a row and row stride ss -> dst [ROWS][ld], by the block's NT threads,
// asynchronously (the caller commits); rows past `rows` as zeros
template <int ROWS, int NT, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, long long ss, int vecs,
                                           int r0, int rows) {
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  for (int idx = threadIdx.x; idx < ROWS * vecs; idx += NT) {
    const int r = idx / vecs, c = (idx - r * vecs) * V;
    const bool ok = r0 + r < rows;
    cp_async16(smem_u32(dst + r * ld + c), src + (ok ? r0 + r : 0) * ss + c, ok ? 16 : 0);
  }
}

// A warp's f32 [16, D] accumulator (the C fragments of its D / 8 n8 tiles),
// rounded to bf16, out to rows w0.. of a [rows, D] output of row stride ss
// in 16-byte stores, through `stage`: 16 staged rows of stride ld that no
// other warp reads
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], __nv_bfloat16* stage,
                                           int ld, __nv_bfloat16* out, long long ss, int w0,
                                           int rows) {
  constexpr int VEC = D / 8;  // 16-byte pieces a row
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<unsigned*>(stage + (gq + 8 * i) * ld + n * 8 + 2 * tq) =
          pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  __syncwarp();
  for (int idx = lane; idx < 16 * VEC; idx += 32) {
    const int r = idx / VEC, c = (idx - r * VEC) * 8;
    if (w0 + r < rows)
      *reinterpret_cast<uint4*>(out + (w0 + r) * ss + c) =
          *reinterpret_cast<const uint4*>(stage + r * ld + c);
  }
}

// a staged f32 row's padding: 4 elements (16 bytes), as MPAD for bf16
constexpr int FPAD = 4;

// The flash-attention kernels' 3xTF32 products (flash_attention_fwd.cu's
// O += P V, flash_attention_bwd.cu's dV, dK and dQ): a warp's [16, D] f32
// accumulator, its A fragments made from C fragments, the product that
// reads a k-major B, and the epilogue.
//
// n8 tiles of an accumulating product summed in one fresh accumulator: 4
// (32 output columns), 2 at d = 128, where dK and dV alone take 128
// registers and the pass's temporaries must fit beside them
template <int D>
constexpr int TF32_GROUP = D <= 64 ? 4 : 2;

// a warp's [16, D] f32 accumulator: groups of TF32_GROUP n8 C fragments
template <int D>
using Tf32Acc = float[D / (8 * TF32_GROUP<D>)][1][TF32_GROUP<D>][4];

// the A register that holds C fragment entry e of an n8 tile made into the A
// fragment of a k8 step: {c0, c2, c1, c3}, so that A's k slot tq is the
// tile's column 2tq and slot tq + 4 its column 2tq + 1
__device__ __forceinline__ constexpr int a_slot(int e) { return ((e & 1) << 1) | (e >> 1); }

// acc[16 own rows, D] += A . B over NK k8 steps in 3xTF32. A: the split P or
// dS fragments of the pass or kv tile (a_slot's k order). B: rows (k) of a staged
// [k][n] f32 tile from `rows` (the pass's first), read in the same k order
// by scalar loads, since ldmatrix cannot transpose 32-bit elements (at a row
// stride of 4 banks the 32 lanes meet no shared bank). Each group of
// TF32_GROUP n8 tiles sums the pass in a fresh accumulator, added to acc in
// f32: the tensor core truncates as it accumulates, and acc sums up to sq or
// sk rows.
template <int D, int NK>
__device__ __forceinline__ void tf32_product(Tf32Acc<D>& acc, const unsigned (&ab)[NK][1][4],
                                             const unsigned (&as)[NK][1][4],
                                             const float* rows) {
  constexpr int LD = D + FPAD;
  constexpr int G = TF32_GROUP<D>;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const float* b = rows + 2 * tq * LD + gq;
#pragma unroll
  for (int g = 0; g < D / (8 * G); ++g) {
    float part[1][G][4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      unsigned bb[G][2], bs[G][2];
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split_tf32(__float_as_uint(b[(kk * 8 + e) * LD + (g * G + j) * 8]), bb[j][e], bs[j][e]);
      mma_tf32x3(part, ab[kk], as[kk], bb, bs);
    }
    add_frags(acc[g], part);
  }
}

// A warp's f32 [16, D] accumulator out to rows w0.. of a [rows, D] f32
// output of row stride ss, a float2 a lane and row
template <int D>
__device__ __forceinline__ void store_rows_f32(const Tf32Acc<D>& acc, float* out, long long ss,
                                               int w0, int rows) {
  constexpr int G = TF32_GROUP<D>;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + gq + 8 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int g = 0; g < D / (8 * G); ++g)
#pragma unroll
      for (int j = 0; j < G; ++j)
        *reinterpret_cast<float2*>(out + row * ss + (g * G + j) * 8 + 2 * tq) =
            make_float2(acc[g][0][j][2 * i], acc[g][0][j][2 * i + 1]);
  }
}

// Thread-block clusters (sm_90): the CTAs of a cluster run at once on
// neighbouring SMs and read each other's shared memory (distributed shared
// memory). lm_loss.cu's backward splits the hidden dim of one own tile
// across a cluster and sums the CTAs' partial S through them.
//
// this CTA's rank in its cluster, and the cluster's CTAs
__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// the cluster barrier in its two halves, each executed by every thread of
// every CTA, and a thread waits before it arrives again. cluster_arrive is
// the CTA's arrive after its threads' shared-memory writes: a CTA barrier,
// then one thread's cluster-scope release fence, which is cumulative (it
// orders every write the CTA barrier showed it), and every thread arrives
// relaxed. A release arrive in all 256 threads cost 15% of lm_loss.cu's
// cluster backward (PERF.md). cluster_wait returns once every thread of
// the cluster has arrived and acquires what their fences released.
__device__ __forceinline__ void cluster_arrive() {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// N consecutive f32 at shared address `local` of this CTA, read from the
// same address in the shared memory of the cluster's CTA `rank`
template <int N>
__device__ __forceinline__ void ld_cluster(unsigned local, unsigned rank, float (&v)[N]) {
  static_assert(N == 2 || N == 4, "a 2- or 4-float vector");
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(local), "r"(rank));
  if constexpr (N == 2)
    asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v[0]), "=f"(v[1]) : "r"(a) : "memory");
  else
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(a) : "memory");
}
// The N floats at `slot` (this CTA's shared memory, 16-byte aligned at N =
// 4) of every CTA of the cluster, summed in f32 in rank order 0, 1, .., so
// that every CTA gets the same bits; after a cluster barrier that follows
// every rank's write of its slot. In two halves, so that a caller can put
// work between them: cluster_load starts the loads of the first four ranks
// into v, cluster_gather sums them and the other ranks' (loaded there, four
// at once) into s.
template <int N>
__device__ __forceinline__ void cluster_load(float (&v)[4][N], const float* slot) {
  const unsigned local = smem_u32(slot);
  const int n = static_cast<int>(cluster_nctarank());
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < n) ld_cluster(local, q, v[q]);
}
template <int N>
__device__ __forceinline__ void cluster_gather(float (&s)[N], float (&v)[4][N], const float* slot) {
  const unsigned local = smem_u32(slot);
  const int n = static_cast<int>(cluster_nctarank());
  for (int r0 = 0; r0 < n; r0 += 4) {
    if (r0 > 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (r0 + q < n) ld_cluster(local, r0 + q, v[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r0 + q < n) {
#pragma unroll
        for (int i = 0; i < N; ++i) s[i] = r0 + q == 0 ? v[q][i] : s[i] + v[q][i];
      }
  }
}
// s (this CTA's partial) summed over the cluster's CTAs as above. Every
// thread of every CTA calls it with its own slot: each writes s there, one
// cluster barrier (a CTA barrier too), then each gathers. A caller that
// calls again before the peers are done reading alternates between two
// slots: the next call's barrier then orders those reads before the slot is
// written again. Before it exits, a CTA arrives and waits once more, so that
// no peer reads the slot of a CTA that has left.
template <int N>
__device__ __forceinline__ void cluster_sum(float (&s)[N], float* slot) {
#pragma unroll
  for (int i = 0; i < N; ++i) slot[i] = s[i];
  cluster_arrive();
  cluster_wait();
  float v[4][N];
  cluster_load(v, slot);
  cluster_gather(s, v, slot);
}

// host: an operand that is copied in 16-byte pieces starts 16-byte aligned,
// and each of its strides is a multiple of the `vec` elements in 16 bytes
// (8 bf16, 4 f32)
inline bool aligned16(const void* ptr, std::initializer_list<long long> strides, int vec = 8) {
  if (reinterpret_cast<unsigned long long>(ptr) % 16) return false;
  for (long long s : strides)
    if (s % vec) return false;
  return true;
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

}  // namespace mma_sync
