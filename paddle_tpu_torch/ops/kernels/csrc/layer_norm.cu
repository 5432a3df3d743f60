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
// Bound at [8192, h]: bytes. The forward reads x and writes o, 2 x 2nh bytes
// in bf16 (12.6 + 12.6 MB = 7.5 us at 3.35 TB/s at h = 768), twice that in
// f32; the backward reads x and dy and writes dx, 3 x 2nh bytes in bf16
// (11.3 us at 768). About 10 flops an element: far below the FP32 units.
//
// What the design does about it, for both dtypes (one template each):
// - A persistent grid: as many CTAs as the card holds at the instance's
//   occupancy (cudaOccupancyMaxActive*, asked once an instance and device),
//   each group of W warps walking rows with a stride of the grid's groups.
// - The next row in flight: a group issues row i + stride's loads into a
//   second set of registers before row i's sums, so a row's loads wait under
//   the previous row's shuffles, affine and stores. Registers, not a ring of
//   rows in shared memory filled by 1-D bulk copies: a row in registers is
//   24-32 values a lane here, so the double buffer costs 12-32 registers a
//   lane and keeps 8-20 warps an SM with 24-54 KB in flight, above the ~18
//   KB an SM needs at the DRAM's latency; a ring would add an mbarrier wait,
//   a shared-memory read of every element and a release per row to feed the
//   same registers, and 8-32 KB of shared memory a row and stage. Measured
//   (tools/layer_norm_ab.py, NVIDIA H100 80GB HBM3, 700 W): the bf16
//   forward's kernel takes ~8.2 us in the profiler against its 7.5 us
//   bound, so a ring has little left to win.
// - 16-byte accesses: a lane's chunk is 16 bytes (8 bf16, 4 f32), so every
//   global load and store of a row is 128 bits. At h = 128 in bf16 half a
//   warp is masked. Rows are read once, evict-first (ld.global.cs).
// - g and b in registers: a lane owns the same columns in every row, so they
//   are loaded once a CTA (the backward keeps g the same way).
// - Row sums: warp shuffles, then (W > 1) the group's warps through shared
//   memory behind the group's own named barrier (one a sum, two alternating
//   slots), in the same order every time.
// - The backward is one launch. dg and db accumulate in registers over a
//   group's rows. At the end the CTA adds its groups in shared memory in
//   group order; the CTAs of a thread-block cluster (up to 8) add theirs
//   through distributed shared memory in rank order, rank r one slice of
//   the columns, and each writes its slice of the cluster's partial row;
//   the last CTA to finish slice r (an integer ticket a slice, taken with
//   one acquire-release atomic after the CTA's barrier, reset by that CTA)
//   adds the cluster rows of the slice in cluster order. The tickets pick
//   who adds, never the order: dx, dg and db are the same bits on every
//   call. This chain of latencies (a cluster barrier, a distributed read, a
//   fence, an atomic, a gather from the L2) follows the last row, so a
//   group's last row stores its dx only after the tickets, under the chain.
//   It is what keeps the bf16 backward below half its bound at h = 768:
//   tools/layer_norm_variants.py times the row walk alone at 20.2 of the
//   backward's 24.7-25.2 us (device_ms, NVIDIA H100 80GB HBM3, 700 W) and
//   reads ~4.9 us from the last walk's end to the kernel's end, ~2.6 of
//   them in the final gather.
//
// Shapes: W warps a row and NV chunks a lane. Forward: up to NV = 8 in f32
// (W = 1 up to h = 1024) and 4 in bf16 (W = 1 up to 1024); backward: NV <= 4
// at both (x, dy, their next row and g, dg, db all stay in registers).
// CTAs of 4 warps, or one group of 8 or 16 warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace {

constexpr int MAX_H = 8192;
constexpr int MAX_CLUSTER = 8;   // CTAs a cluster may portably hold
constexpr int MAX_DEVICES = 64;
constexpr int FINAL_LOADS = 24;  // float4s a thread loads at once in the final sum

// threads of a CTA: four warps, or one group of W warps past four
__host__ __device__ constexpr int cta_threads(int w) { return w <= 4 ? 128 : 32 * w; }

// 16 bytes of T as f32, and back (one round to nearest even, as astype)
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[N]) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[N]) {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half (the lower address)
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[N]) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&t);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// a lane's NV chunks of one row (16 bytes each, chunk k = c * L + lane);
// zeros past the row's chunks and for a row past n. Rows are read once:
// evict-first (ld.global.cs), so they do not push other lines out of the L2
template <int L, int NV>
__device__ __forceinline__ void load_row(const void* __restrict__ base, int row, int n, int h,
                                         int esize, int lane, int chunks, uint4 (&r)[NV]) {
  const uint4* p = reinterpret_cast<const uint4*>(
      static_cast<const char*>(base) + static_cast<long long>(row < n ? row : 0) * h * esize);
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int k = c * L + lane;
    r[c] = row < n && k < chunks ? __ldcs(p + k) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// a lane's columns of an f32 [h] vector (g or b), E a chunk
template <int L, int NV, int E>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, int lane, int chunks,
                                          float (&v)[NV][E]) {
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int k = c * L + lane;
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      const float4 t = k < chunks ? __ldg(reinterpret_cast<const float4*>(p + E * k) + j)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      v[c][4 * j] = t.x; v[c][4 * j + 1] = t.y; v[c][4 * j + 2] = t.z; v[c][4 * j + 3] = t.w;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The K sums x over the W warps of a group, every thread of the group
// calling. W > 1: each warp's sums go to red[parity] (K x NTH / 32 floats a
// slot), the group meets at its named barrier (id 1 + group), and every
// warp adds the W sums in warp order. The slots alternate: a warp writes a
// slot again only after the next call's barrier, which every warp of the
// group reaches after reading it.
template <int W, int NTH, int K>
__device__ __forceinline__ void group_sum(float (&x)[K], float* red, int& parity) {
#pragma unroll
  for (int i = 0; i < K; ++i) x[i] = warp_sum(x[i]);
  if constexpr (W > 1) {
    const int warp = threadIdx.x >> 5;
    const int first = warp - warp % W;
    float* slot = red + parity * K * (NTH / 32);
    parity ^= 1;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < K; ++i) slot[i * (NTH / 32) + warp] = x[i];
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + warp / W), "r"(32 * W) : "memory");
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) s += slot[i * (NTH / 32) + first + w];
      x[i] = s;
    }
  }
}

// the next row of a walk with the given stride, n when there is none
__device__ __forceinline__ int next_row(int row, int stride, int n) {
  return row < n - stride ? row + stride : n;
}

template <typename T, int W, int NV, bool STATS>
__global__ void __launch_bounds__(W <= 4 ? 128 : 32 * W)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ b, T* __restrict__ o, float* __restrict__ mu_out,
                  float* __restrict__ rstd_out, int n, int h, float eps) {
  constexpr int NTH = cta_threads(W), L = 32 * W, G = NTH / L, E = Vec<T>::N;
  __shared__ float red[2 * (NTH / 32)];
  const int lane = threadIdx.x % L;
  const int chunks = h / E;
  const float hf = static_cast<float>(h);
  const int stride = gridDim.x * G;

  float gam[NV][E], bet[NV][E];
  load_cols<L, NV, E>(g, lane, chunks, gam);
  load_cols<L, NV, E>(b, lane, chunks, bet);

  int row = blockIdx.x * G + threadIdx.x / L;
  int parity = 0;
  uint4 cur[NV];
  load_row<L, NV>(x, row, n, h, sizeof(T), lane, chunks, cur);
  while (row < n) {
    const int next = next_row(row, stride, n);
    uint4 nxt[NV];
    load_row<L, NV>(x, next, n, h, sizeof(T), lane, chunks, nxt);  // in flight from here

    float v[NV][E];
    float s[1] = {0.f};
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      Vec<T>::unpack(cur[c], v[c]);
#pragma unroll
      for (int q = 0; q < E; ++q) s[0] += v[c][q];
    }
    group_sum<W, NTH, 1>(s, red, parity);
    const float mean = s[0] / hf;

    float ss[1] = {0.f};
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const bool ok = c * L + lane < chunks;
#pragma unroll
      for (int q = 0; q < E; ++q) {
        v[c][q] = ok ? v[c][q] - mean : 0.f;
        ss[0] += v[c][q] * v[c][q];
      }
    }
    group_sum<W, NTH, 1>(ss, red, parity);
    const float rstd = rsqrtf(ss[0] / hf + eps);

    uint4* orow = reinterpret_cast<uint4*>(o + static_cast<long long>(row) * h);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int k = c * L + lane;
      if (k < chunks) {
        float out[E];
#pragma unroll
        for (int q = 0; q < E; ++q)
          out[q] = __fadd_rn(__fmul_rn(__fmul_rn(v[c][q], rstd), gam[c][q]), bet[c][q]);
        orow[k] = Vec<T>::pack(out);
      }
    }
    if (STATS && lane == 0) {
      mu_out[row] = mean;
      rstd_out[row] = rstd;
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) cur[c] = nxt[c];
    row = next;
  }
}

// a row's dx from its x and dy (a lane's chunks, as loaded), g, mu, rstd
// and the row's two means c1 = mean(g dy), c2 = mean(g dy xhat)
template <typename T, int L, int NV>
__device__ __forceinline__ void store_dx(T* __restrict__ dx, int row, int h, int lane, int chunks,
                                         const uint4 (&cx)[NV], const uint4 (&cd)[NV],
                                         const float (&gam)[NV][Vec<T>::N], float m, float r,
                                         float c1, float c2) {
  constexpr int E = Vec<T>::N;
  uint4* drow = reinterpret_cast<uint4*>(dx + static_cast<long long>(row) * h);
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int k = c * L + lane;
    if (k < chunks) {
      float xv[E], dv[E], out[E];
      Vec<T>::unpack(cx[c], xv);
      Vec<T>::unpack(cd[c], dv);
#pragma unroll
      for (int q = 0; q < E; ++q) {
        const float xh = (xv[q] - m) * r;
        out[q] = (dv[q] * gam[c][q] - c1 - xh * c2) * r;
      }
      drow[k] = Vec<T>::pack(out);
    }
  }
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
}

// four float4 at the shared::cluster addresses a[0..3], loaded at once
__device__ __forceinline__ void ld_cluster4x4(const unsigned (&a)[4], float (&v)[4][4]) {
  asm volatile(
      "ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%16];\n"
      "ld.shared::cluster.v4.f32 {%4, %5, %6, %7}, [%17];\n"
      "ld.shared::cluster.v4.f32 {%8, %9, %10, %11}, [%18];\n"
      "ld.shared::cluster.v4.f32 {%12, %13, %14, %15}, [%19];\n"
      : "=f"(v[0][0]), "=f"(v[0][1]), "=f"(v[0][2]), "=f"(v[0][3]), "=f"(v[1][0]),
        "=f"(v[1][1]), "=f"(v[1][2]), "=f"(v[1][3]), "=f"(v[2][0]), "=f"(v[2][1]),
        "=f"(v[2][2]), "=f"(v[2][3]), "=f"(v[3][0]), "=f"(v[3][1]), "=f"(v[3][2]), "=f"(v[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])
      : "memory");
}

// the float4 at p (shared memory) summed over the cluster's cn CTAs in rank
// order; every rank's load is issued before the first add (a rank past cn
// reads rank 0 again and is not added)
__device__ __forceinline__ float4 rank_sum(const float4* p, int cn) {
  const unsigned local = mma_sync::smem_u32(p);
  unsigned a[2][4];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
        : "=r"(a[q / 4][q % 4]) : "r"(local), "r"(q < cn ? q : 0));
  float v[2][4][4];
  ld_cluster4x4(a[0], v[0]);
  ld_cluster4x4(a[1], v[1]);
  float4 t = make_float4(v[0][0][0], v[0][0][1], v[0][0][2], v[0][0][3]);
#pragma unroll
  for (int q = 1; q < MAX_CLUSTER; ++q)
    if (q < cn) {
      const float* u = v[q / 4][q % 4];
      add4(t, make_float4(u[0], u[1], u[2], u[3]));
    }
  return t;
}

// the cluster barrier's arrive with nothing to release (this CTA's shared
// memory is not written again before the matching wait)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// the ticket's value before this CTA's increment (acquire and release, gpu scope)
__device__ __forceinline__ unsigned take_ticket(unsigned* t) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(t) : "memory");
  return old;
}

// dx for every row, and dg, db (dgdb = [dg | db], 2h f32) through the
// clusters' partial rows part ([clusters][2h] f32); ticket[r] (r < 8, the
// column slice of rank r) is 0 at the launch and again at its end. Dynamic
// shared memory: [G][2h] f32.
template <typename T, int W, int NV>
__global__ void __launch_bounds__(W <= 4 ? 128 : 32 * W)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                  const T* __restrict__ dy, const float* __restrict__ mu,
                  const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ part,
                  float* __restrict__ dgdb, unsigned* __restrict__ ticket, int n, int h) {
  using namespace mma_sync;
  constexpr int NTH = cta_threads(W), L = 32 * W, G = NTH / L, E = Vec<T>::N;
  extern __shared__ float4 sm4[];
  __shared__ float red[2 * 2 * (NTH / 32)];
  __shared__ unsigned last_flag;
  __shared__ float4 runs[NTH];
  const int lane = threadIdx.x % L;
  const int grp = threadIdx.x / L;
  const int chunks = h / E;
  const float hf = static_cast<float>(h);
  const int stride = gridDim.x * G;

  float gam[NV][E], acc_g[NV][E], acc_b[NV][E];
  load_cols<L, NV, E>(g, lane, chunks, gam);
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int q = 0; q < E; ++q) acc_g[c][q] = acc_b[c][q] = 0.f;

  int row = blockIdx.x * G + grp;
  int parity = 0;
  uint4 cx[NV], cd[NV];
  load_row<L, NV>(x, row, n, h, sizeof(T), lane, chunks, cx);
  load_row<L, NV>(dy, row, n, h, sizeof(T), lane, chunks, cd);
  float cm = row < n ? mu[row] : 0.f, cr = row < n ? rstd[row] : 0.f;
  float c1 = 0.f, c2 = 0.f;
  int last_row = -1;  // the group's last row: its dx is stored after the tickets
  while (row < n) {
    const int next = next_row(row, stride, n);
    uint4 nx[NV], nd[NV];
    load_row<L, NV>(x, next, n, h, sizeof(T), lane, chunks, nx);  // in flight from here
    load_row<L, NV>(dy, next, n, h, sizeof(T), lane, chunks, nd);
    const float nm = next < n ? mu[next] : 0.f, nr = next < n ? rstd[next] : 0.f;

    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float xv[E], dv[E];
      Vec<T>::unpack(cx[c], xv);
      Vec<T>::unpack(cd[c], dv);
#pragma unroll
      for (int q = 0; q < E; ++q) {
        const float xh = (xv[q] - cm) * cr;  // past the row: dv = g = 0
        const float wdy = dv[q] * gam[c][q];
        s[0] += wdy;
        s[1] += wdy * xh;
        acc_g[c][q] += dv[q] * xh;
        acc_b[c][q] += dv[q];
      }
    }
    group_sum<W, NTH, 2>(s, red, parity);
    c1 = s[0] / hf;
    c2 = s[1] / hf;
    if (next >= n) {
      last_row = row;
      break;
    }
    store_dx<T, L, NV>(dx, row, h, lane, chunks, cx, cd, gam, cm, cr, c1, c2);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      cx[c] = nx[c];
      cd[c] = nd[c];
    }
    cm = nm;
    cr = nr;
    row = next;
  }

  // the CTA's column sums: each group's [dg | db] into its slot, then the
  // groups added in order into slot 0
  const int n4 = h / 2;  // float4s of [dg | db]
  float* slot = reinterpret_cast<float*>(sm4) + static_cast<long long>(grp) * 2 * h;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int k = c * L + lane;
    if (k < chunks) {
#pragma unroll
      for (int j = 0; j < E / 4; ++j) {
        reinterpret_cast<float4*>(slot + E * k)[j] = make_float4(
            acc_g[c][4 * j], acc_g[c][4 * j + 1], acc_g[c][4 * j + 2], acc_g[c][4 * j + 3]);
        reinterpret_cast<float4*>(slot + h + E * k)[j] = make_float4(
            acc_b[c][4 * j], acc_b[c][4 * j + 1], acc_b[c][4 * j + 2], acc_b[c][4 * j + 3]);
      }
    }
  }
  __syncthreads();
  if constexpr (G > 1) {
    for (int j = threadIdx.x; j < n4; j += NTH) {
      float4 t = sm4[j];
#pragma unroll
      for (int gi = 1; gi < G; ++gi) add4(t, sm4[gi * n4 + j]);
      sm4[j] = t;
    }
  }

  // the cluster's partial row: rank r adds its slice of the columns over the
  // ranks in rank order and takes the slice's ticket
  cluster_arrive();
  cluster_wait();  // every CTA's sum is in its slot 0
  const int cn = static_cast<int>(cluster_nctarank());
  const int rank = static_cast<int>(cluster_ctarank());
  const int clusters = gridDim.x / cn;
  const int j0 = rank * n4 / cn, j1 = (rank + 1) * n4 / cn;
  float4* part4 = reinterpret_cast<float4*>(part);
  for (int j = j0 + threadIdx.x; j < j1; j += NTH)
    part4[static_cast<long long>(blockIdx.x / cn) * n4 + j] = rank_sum(sm4 + j, cn);
  __syncthreads();   // the CTA's slice written, its reads of the peers' slots done
  cluster_arrive_relaxed();
  if (threadIdx.x == 0) {  // the ticket's release covers the CTA's slice (the barrier above)
    const bool last = take_ticket(ticket + rank) == static_cast<unsigned>(clusters - 1);
    if (last) *reinterpret_cast<volatile unsigned*>(ticket + rank) = 0u;  // all have taken theirs
    last_flag = last;
  }
  __syncthreads();
  if (last_row >= 0) store_dx<T, L, NV>(dx, last_row, h, lane, chunks, cx, cd, gam, cm, cr, c1, c2);

  // the slice's last CTA: the clusters' rows of its slice added in cluster
  // order; `parts` threads a column, each over a run of consecutive rows
  // (FINAL_LOADS loads in flight), the runs then added in order. Plain
  // loads: the ticket's acquire (then the CTA barrier) orders them after
  // every slice's release
  if (last_flag) {
    const int cols = j1 - j0;
    const int parts = cols >= NTH ? 1 : NTH / cols;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    const int col = threadIdx.x % cols, run = threadIdx.x / cols;
    const bool active = run < parts;  // cols >= 8: n4 >= 64, cn <= 8
    const int r0 = active ? run * clusters / parts : 0;
    const int r1 = active ? (run + 1) * clusters / parts : 0;
    constexpr int FL = NTH > 256 ? FINAL_LOADS / 3 : FINAL_LOADS;  // 128 registers at 512
    for (int jc = col; active && jc < cols; jc += NTH) {
      t = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p0 = r0; p0 < r1; p0 += FL) {
        float4 v[FL];
#pragma unroll
        for (int i = 0; i < FL; ++i)
          if (p0 + i < r1) v[i] = part4[static_cast<long long>(p0 + i) * n4 + j0 + jc];
#pragma unroll
        for (int i = 0; i < FL; ++i)
          if (p0 + i < r1) add4(t, v[i]);
      }
      if (parts == 1) reinterpret_cast<float4*>(dgdb)[j0 + jc] = t;
    }
    if (parts > 1) {
      if (active) runs[threadIdx.x] = t;
      __syncthreads();
      if (threadIdx.x < cols) {
        float4 u = runs[threadIdx.x];
        for (int q = 1; q < parts; ++q) add4(u, runs[q * cols + threadIdx.x]);
        reinterpret_cast<float4*>(dgdb)[j0 + threadIdx.x] = u;
      }
    }
  }
  cluster_wait();  // no CTA leaves while a peer reads its slot
}

// W warps a row and NV chunks of E elements a lane for hidden size h (a
// multiple of 128): the fewest warps, a power of two up to max_w, that hold
// the row in at most nv_max chunks a lane; with `even`, NV 3, 5, 7 round up
// to the instances 4, 6, 8
bool shape_for(int h, int e, int nv_max, int max_w, bool even, int* w, int* nv) {
  if (h <= 0 || h % 128 != 0 || h > MAX_H) return false;
  const int chunks = h / e;
  int warps = 1;
  while (warps < max_w && chunks > 32 * warps * nv_max) warps *= 2;
  int need = (chunks + 32 * warps - 1) / (32 * warps);
  if (need > nv_max) return false;
  if (even && need > 2) need += need % 2;
  *w = warps;
  *nv = need;
  return true;
}

bool fwd_shape(int dtype, int h, int* w, int* nv) {
  return dtype == 0 ? shape_for(h, 4, 8, 8, true, w, nv) : shape_for(h, 8, 4, 8, false, w, nv);
}
bool bwd_shape(int dtype, int h, int* w, int* nv) {
  return dtype == 0 ? shape_for(h, 4, 4, 16, false, w, nv)
                    : shape_for(h, 8, 4, 8, false, w, nv);
}

int sm_count(int dev) {
  static int sms[MAX_DEVICES] = {};
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms[dev];
}

cudaError_t current_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e == cudaSuccess && (*dev < 0 || *dev >= MAX_DEVICES)) e = cudaErrorInvalidDevice;
  return e;
}

template <typename T, int W, int NV>
cudaError_t fwd_launch(const void* x, const float* g, const float* b, void* o, float* mu,
                       float* rstd, int n, int h, float eps, bool stats, cudaStream_t st) {
  constexpr int NTH = cta_threads(W), G = NTH / (32 * W);
  static int occ[2][MAX_DEVICES] = {};  // CTAs an SM, by STATS
  int dev;
  cudaError_t e = current_device(&dev);
  if (e != cudaSuccess) return e;
  int& blocks = occ[stats][dev];
  if (blocks == 0) {
    e = stats ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, ln_fwd_kernel<T, W, NV, true>, NTH, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, ln_fwd_kernel<T, W, NV, false>, NTH, 0);
    if (e != cudaSuccess) return e;
    if (blocks < 1) return cudaErrorLaunchOutOfResources;
  }
  const long long need = (static_cast<long long>(n) + G - 1) / G;
  const long long full = static_cast<long long>(sm_count(dev)) * blocks;
  const int grid = static_cast<int>(need < full ? need : full);
  if (grid < 1) return cudaErrorInvalidValue;
  if (stats)
    ln_fwd_kernel<T, W, NV, true><<<grid, NTH, 0, st>>>(
        static_cast<const T*>(x), g, b, static_cast<T*>(o), mu, rstd, n, h, eps);
  else
    ln_fwd_kernel<T, W, NV, false><<<grid, NTH, 0, st>>>(
        static_cast<const T*>(x), g, b, static_cast<T*>(o), nullptr, nullptr, n, h, eps);
  return cudaGetLastError();
}

// The backward's launch shape for n rows: clusters of `cluster` CTAs (8, or
// fewer where there are fewer row blocks or the card holds no cluster of 8)
// and `clusters` of them, as many as the card holds at once and the rows
// need. Dynamic shared memory: the instance's widest [G][2h], so that one
// occupancy answer (asked once an instance, device and cluster size) holds
// for every h it takes.
template <typename T, int W, int NV>
struct Bwd {
  static constexpr int NTH = cta_threads(W), G = NTH / (32 * W);
  static constexpr int SMEM = G * 2 * 32 * W * NV * Vec<T>::N * 4;

  static void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], int cluster,
                     int clusters, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(cluster * clusters);
    cfg.blockDim = dim3(NTH);
    cfg.dynamicSmemBytes = SMEM;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }

  static cudaError_t plan(int n, int* cluster, int* clusters) {
    static int fits[MAX_DEVICES][MAX_CLUSTER + 1] = {};  // 0 unknown, -1 none
    static bool attr_set[MAX_DEVICES] = {};
    int dev;
    cudaError_t e = current_device(&dev);
    if (e != cudaSuccess) return e;
    if (!attr_set[dev]) {
      e = cudaFuncSetAttribute(ln_bwd_kernel<T, W, NV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
      if (e != cudaSuccess) return e;
      attr_set[dev] = true;
    }
    const long long blocks = (static_cast<long long>(n) + G - 1) / G;
    for (int c = blocks < MAX_CLUSTER ? static_cast<int>(blocks) : MAX_CLUSTER; c >= 1;
         c /= 2) {
      if (fits[dev][c] == 0) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        config(cfg, attr, c, 1, nullptr);
        int most = 0;
        e = cudaOccupancyMaxActiveClusters(
            &most, reinterpret_cast<const void*>(ln_bwd_kernel<T, W, NV>), &cfg);
        if (e != cudaSuccess) return e;
        fits[dev][c] = most > 0 ? most : -1;
      }
      if (fits[dev][c] > 0) {
        const long long need = (blocks + c - 1) / c;
        *cluster = c;
        *clusters = static_cast<int>(need < fits[dev][c] ? need : fits[dev][c]);
        return cudaSuccess;
      }
    }
    return cudaErrorLaunchOutOfResources;
  }

  static cudaError_t launch(const void* x, const float* g, const void* dy, const float* mu,
                            const float* rstd, void* dx, float* part, float* dgdb,
                            unsigned* ticket, int n, int h, int clusters, cudaStream_t st) {
    int c, k;
    cudaError_t e = plan(n, &c, &k);
    if (e != cudaSuccess) return e;
    if (k != clusters) return cudaErrorInvalidValue;  // part holds `clusters` rows
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    config(cfg, attr, c, k, st);
    e = cudaLaunchKernelEx(&cfg, ln_bwd_kernel<T, W, NV>, static_cast<const T*>(x), g,
                           static_cast<const T*>(dy), mu, rstd, static_cast<T*>(dx), part,
                           dgdb, ticket, n, h);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
};

// the clusters for n rows, or minus a cudaError_t
template <typename T, int W, int NV>
int bwd_clusters(int n) {
  int c, k;
  const cudaError_t e = Bwd<T, W, NV>::plan(n, &c, &k);
  return e != cudaSuccess ? -static_cast<int>(e) : k;
}
template <typename T, int W, int NV>
cudaError_t bwd_launch(const void* x, const float* g, const void* dy, const float* mu,
                       const float* rstd, void* dx, float* part, float* dgdb, unsigned* ticket,
                       int n, int h, int clusters, cudaStream_t st) {
  return Bwd<T, W, NV>::launch(x, g, dy, mu, rstd, dx, part, dgdb, ticket, n, h, clusters, st);
}

// the (W, NV) instances shape_for can pick: NV 1-4 at W = 1 and 3-4 past it
// (bf16; the f32 backward up to W = 16), NV 1, 2, 4, 6, 8 and 6-8 (the f32
// forward)
#define LN_CASE(FN, T, W, NV, ...) \
  case (W) * 16 + (NV): return FN<T, W, NV>(__VA_ARGS__);
#define LN_NV4(FN, T, ...)                                                             \
  LN_CASE(FN, T, 1, 1, __VA_ARGS__) LN_CASE(FN, T, 1, 2, __VA_ARGS__)                  \
  LN_CASE(FN, T, 1, 3, __VA_ARGS__) LN_CASE(FN, T, 1, 4, __VA_ARGS__)                  \
  LN_CASE(FN, T, 2, 3, __VA_ARGS__) LN_CASE(FN, T, 2, 4, __VA_ARGS__)                  \
  LN_CASE(FN, T, 4, 3, __VA_ARGS__) LN_CASE(FN, T, 4, 4, __VA_ARGS__)                  \
  LN_CASE(FN, T, 8, 3, __VA_ARGS__) LN_CASE(FN, T, 8, 4, __VA_ARGS__)
#define LN_NV8(FN, T, ...)                                                             \
  LN_CASE(FN, T, 1, 1, __VA_ARGS__) LN_CASE(FN, T, 1, 2, __VA_ARGS__)                  \
  LN_CASE(FN, T, 1, 4, __VA_ARGS__) LN_CASE(FN, T, 1, 6, __VA_ARGS__)                  \
  LN_CASE(FN, T, 1, 8, __VA_ARGS__) LN_CASE(FN, T, 2, 6, __VA_ARGS__)                  \
  LN_CASE(FN, T, 2, 8, __VA_ARGS__) LN_CASE(FN, T, 4, 6, __VA_ARGS__)                  \
  LN_CASE(FN, T, 4, 8, __VA_ARGS__) LN_CASE(FN, T, 8, 6, __VA_ARGS__)                  \
  LN_CASE(FN, T, 8, 8, __VA_ARGS__)

cudaError_t fwd_dispatch(int dtype, int w, int nv, const void* x, const float* g,
                         const float* b, void* o, float* mu, float* rstd, int n, int h,
                         float eps, bool stats, cudaStream_t st) {
  if (dtype == 0) {
    switch (w * 16 + nv) {
      LN_NV8(fwd_launch, float, x, g, b, o, mu, rstd, n, h, eps, stats, st)
      default: return cudaErrorInvalidValue;
    }
  }
  switch (w * 16 + nv) {
    LN_NV4(fwd_launch, __nv_bfloat16, x, g, b, o, mu, rstd, n, h, eps, stats, st)
    default: return cudaErrorInvalidValue;
  }
}

int bwd_clusters_dispatch(int dtype, int w, int nv, int n) {
  if (dtype == 0) {
    switch (w * 16 + nv) {
      LN_NV4(bwd_clusters, float, n)
      LN_CASE(bwd_clusters, float, 16, 3, n)
      LN_CASE(bwd_clusters, float, 16, 4, n)
      default: return -static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (w * 16 + nv) {
    LN_NV4(bwd_clusters, __nv_bfloat16, n)
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

cudaError_t bwd_dispatch(int dtype, int w, int nv, const void* x, const float* g,
                         const void* dy, const float* mu, const float* rstd, void* dx,
                         float* part, float* dgdb, unsigned* ticket, int n, int h,
                         int clusters, cudaStream_t st) {
  if (dtype == 0) {
    switch (w * 16 + nv) {
      LN_NV4(bwd_launch, float, x, g, dy, mu, rstd, dx, part, dgdb, ticket, n, h, clusters, st)
      LN_CASE(bwd_launch, float, 16, 3, x, g, dy, mu, rstd, dx, part, dgdb, ticket, n, h,
              clusters, st)
      LN_CASE(bwd_launch, float, 16, 4, x, g, dy, mu, rstd, dx, part, dgdb, ticket, n, h,
              clusters, st)
      default: return cudaErrorInvalidValue;
    }
  }
  switch (w * 16 + nv) {
    LN_NV4(bwd_launch, __nv_bfloat16, x, g, dy, mu, rstd, dx, part, dgdb, ticket, n, h,
           clusters, st)
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, o: [n, h] contiguous, 16-byte aligned, dtype 0 = float32, 1 = bfloat16;
// g, b: [h] f32; mu, rstd: [n] f32, written when stats != 0 (the training
// forward), else unused (the inference forward). h a multiple of 128, at
// most 8192. Returns cudaGetLastError() of the launch.
extern "C" int layer_norm_fwd(const void* x, const void* g, const void* b, void* o, void* mu,
                              void* rstd, int dtype, int n, int h, float eps, int stats,
                              void* stream) {
  int w, nv;
  if ((dtype != 0 && dtype != 1) || !fwd_shape(dtype, h, &w, &nv))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(fwd_dispatch(dtype, w, nv, x, static_cast<const float*>(g),
                                       static_cast<const float*>(b), o,
                                       static_cast<float*>(mu), static_cast<float*>(rstd), n,
                                       h, eps, stats != 0, static_cast<cudaStream_t>(stream)));
}

// The number of cluster partial rows the backward writes for [n, h] of
// `dtype` on the current device (the rows of its `part` scratch), or minus a
// cudaError_t.
extern "C" int layer_norm_bwd_clusters(int n, int h, int dtype) {
  int w, nv;
  if ((dtype != 0 && dtype != 1) || n < 1 || !bwd_shape(dtype, h, &w, &nv))
    return -static_cast<int>(cudaErrorInvalidValue);
  return bwd_clusters_dispatch(dtype, w, nv, n);
}

// x, dy, dx: [n, h] contiguous, 16-byte aligned, in x's dtype; g: [h] f32;
// mu, rstd: [n] f32 from the training forward; part: [clusters, 2, h] f32
// scratch with clusters = layer_norm_bwd_clusters(n, h, dtype); dgdb: [2, h]
// f32 out (dg, then db); ticket: 8 u32, 0 before the call and after it,
// used by one stream at a time. One launch. Returns cudaGetLastError().
extern "C" int layer_norm_bwd(const void* x, const void* g, const void* dy, const void* mu,
                              const void* rstd, void* dx, void* part, void* dgdb, void* ticket,
                              int dtype, int n, int h, int clusters, void* stream) {
  int w, nv;
  if ((dtype != 0 && dtype != 1) || n < 1 || clusters < 1 || !bwd_shape(dtype, h, &w, &nv))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bwd_dispatch(
      dtype, w, nv, x, static_cast<const float*>(g), dy, static_cast<const float*>(mu),
      static_cast<const float*>(rstd), dx, static_cast<float*>(part), static_cast<float*>(dgdb),
      static_cast<unsigned*>(ticket), n, h, clusters, static_cast<cudaStream_t>(stream)));
}
