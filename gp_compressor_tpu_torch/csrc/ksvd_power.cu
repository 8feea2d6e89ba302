// K-SVD atom block update for Hopper: each atom's NIPALS power iteration
// over that atom's users only, the whole fixed-count loop in one launch.
//
// Replaces no TPU kernel: the JAX package runs this step as XLA ops
// (gp_compressor_tpu/models/dictionary.py::_atom_sweep). The port's plain
// version (models/dictionary.py::_block_update_plain) builds, for a block
// of b atoms, the dense stack A_j = (R + W o x_j d_j^T) o using_j of
// [b, n, l] over every patch row and runs 20 rounds of two batched GEMVs
// on it. A patch uses at most words_max of K atoms, so an atom's users are
// a few per cent of the rows, and every other row of A_j is exactly zero.
// This kernel computes the same (u, x_new) from the user rows alone.
//
// What bounds it on this card: the chain of cluster-wide reductions, not
// bytes. Each round needs the previous round's u in full, so a launch is
// iters + 1 dependent exchanges across the atom's CTAs; the user rows
// (tens to a few thousand of l floats) sit in shared memory or L2 and are
// read in microseconds. The design keeps that chain short:
//
//  1. One thread-block cluster of kCluster CTAs per atom, one launch per
//     block of atoms. An atom's users are dealt out round-robin by rank,
//     so a skewed atom (most rows its users) still spreads evenly over
//     kCluster SMs. Each CTA finds its users itself from using[j, :]
//     (a count per thread and one scan over the block); no count goes to
//     the host.
//  2. Each CTA stages its user rows A_i = R_i + (x_i d) o W_i in dynamic
//     shared memory, as many as fit (rows_cap); the rest it re-forms from
//     R and W, which stay in L2, on each pass. The wrapper holds a CTA to
//     half an SM's shared memory, so that two CTAs share an SM and a
//     block's 16 clusters run at once (with the whole 227 KB a CTA, the
//     card runs 15 clusters of 8 at once, and the 16th waits for them).
//     The sums keep two to four loads in flight a thread.
//  3. One exchange per round: v'_i = u . A_i (a warp per row), then the
//     CTA's partial sums p = sum_i v'_i A_i and q = sum_i v'_i^2 go to its
//     shared memory, and after one cluster barrier every CTA adds the
//     kCluster partials in rank order through distributed shared memory:
//     u = p / max(sqrt(q), 1e-30). That is the plain version's
//     v = unit(u A), u = A^T v with the division by |v| taken after the
//     sum (one barrier per round instead of two). The partials are double
//     buffered, so a round needs no second barrier. Every CTA then holds
//     the same u (the same sums in the same order).
//  4. The finish: sigma = |u|, u /= max(sigma, 1e-30), v = unit(u A) (one
//     more exchange of q), x_new = sigma v on the users.
//
// Semantics of the plain version kept exactly where it is not a question
// of summation order: rows formed with the same two roundings (no fused
// multiply-add), clamps that let NaN through, x_new = sigma v o using on
// the non-users (0, or NaN when sigma or u is not finite), an atom without
// users keeps d_j and x_j. A non-finite value anywhere in the dense stack
// reaches every output of the atom through 0 x NaN; the kernel gets that
// from a flag instead of the rows: rmax = max |R| (one reduction per block,
// by the wrapper), and x_j, d_j checked here. Then u and x_new are NaN.
//
// Instantiated for float and double.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;      // CTAs per atom
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_of(float) { return CUDART_NAN_F; }
__device__ __forceinline__ double nan_of(double) { return CUDART_NAN; }
__device__ __forceinline__ float sqrt_of(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_of(double a) { return sqrt(a); }
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// torch.clamp(x, min=lo): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

// A_ik = R_ik + (x_i d_k) W_ik, rounded as the plain version's
// R + (xj dj) o W
template <typename T>
__device__ __forceinline__ T row_elem(T r, T w, T x, T d) {
  return add_rn(r, mul_rn(mul_rn(x, d), w));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The block's sum of v, the same value (same order) in every thread.
template <typename T>
__device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
ksvd_power_kernel(const T* __restrict__ R, const T* __restrict__ W,
                  const T* __restrict__ dj, long long dj_s0, long long dj_s1,
                  const T* __restrict__ xj, const uint8_t* __restrict__ users,
                  const T* __restrict__ rmax, T* __restrict__ u_out,
                  T* __restrict__ x_out, int n, int l, int iters,
                  int idx_cap, int rows_cap) {
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = static_cast<int>(cluster.block_rank());
  const int j = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // layout: rows [rows_cap][l], u [l], d [l], part [2][l + 1],
  // vv [idx_cap], red [kWarps]; idx [idx_cap], wcount [kWarps] (ints)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows = reinterpret_cast<T*>(smem_raw);
  T* u = rows + static_cast<size_t>(rows_cap) * l;
  T* d = u + l;
  T* part = d + l;
  T* vv = part + 2 * (l + 1);
  T* red = vv + idx_cap;
  int* idx = reinterpret_cast<int*>(red + kWarps);
  int* wcount = idx + idx_cap;

  const T* xrow = xj + static_cast<size_t>(j) * n;
  const uint8_t* urow = users + static_cast<size_t>(j) * n;
  T* xo = x_out + static_cast<size_t>(j) * n;

  // ---- this CTA's users (ranks r with r % kCluster == crank, in row
  // order), the atom's user count, and the non-finite flag: thread t
  // counts the users of its run of seg rows, an exclusive scan over the
  // block gives its first rank, and it deals its users out
  bool bad = false;
  const int seg = (n + kThreads - 1) / kThreads;
  const int i0 = min(n, tid * seg), i1 = min(n, i0 + seg);
  int mine = 0;
  for (int i = i0; i < i1; ++i) {
    mine += urow[i] != 0;
    if (!isfinite(xrow[i])) bad = true;
  }
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wcount[warp] = incl;
  __syncthreads();
  int rank = incl - mine, cnt = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) rank += wcount[w];
    cnt += wcount[w];
  }
  for (int i = i0; i < i1; ++i)
    if (urow[i] != 0) {
      if (rank % kCluster == crank) idx[rank / kCluster] = i;
      ++rank;
    }
  for (int k = tid; k < l; k += kThreads) {
    const T dk = dj[j * dj_s0 + k * dj_s1];
    d[k] = dk;
    if (!isfinite(dk)) bad = true;
  }
  if (!isfinite(*rmax)) bad = true;
  const bool poison = __syncthreads_or(bad) != 0;
  // the slice of x_out's non-user entries this CTA writes
  const int lo = static_cast<int>(static_cast<long long>(n) * crank / kCluster);
  const int hi =
      static_cast<int>(static_cast<long long>(n) * (crank + 1) / kCluster);

  // cnt and poison are the same in every CTA of the cluster
  if (cnt == 0 || poison) {
    for (int i = lo + tid; i < hi; i += kThreads)
      xo[i] = cnt == 0 ? xrow[i] : nan_of(T());
    if (crank == 0)
      for (int k = tid; k < l; k += kThreads)
        u_out[static_cast<size_t>(j) * l + k] = cnt == 0 ? d[k] : nan_of(T());
    return;
  }

  const int m = cnt > crank ? (cnt - crank + kCluster - 1) / kCluster : 0;
  const int staged = m < rows_cap ? m : rows_cap;
  for (int s = warp; s < staged; s += kWarps) {
    const int i = idx[s];
    const T x = xrow[i];
    const T* Ri = R + static_cast<size_t>(i) * l;
    const T* Wi = W + static_cast<size_t>(i) * l;
    T* Ai = rows + static_cast<size_t>(s) * l;
    for (int k = lane; k < l; k += 32) Ai[k] = row_elem(Ri[k], Wi[k], x, d[k]);
  }
  const T u0 = T(1) / sqrt_of(T(l));
  for (int k = tid; k < l; k += kThreads) u[k] = u0;
  __syncthreads();

  // vv[s] = u . A_s over this CTA's rows, a warp per row
  auto v_step = [&]() {
    for (int s = warp; s < m; s += kWarps) {
      // two sums a lane, for two loads in flight
      T a0 = 0, a1 = 0;
      int k = lane;
      if (s < staged) {
        const T* Ai = rows + static_cast<size_t>(s) * l;
        for (; k + 32 < l; k += 64) {
          a0 += u[k] * Ai[k];
          a1 += u[k + 32] * Ai[k + 32];
        }
        if (k < l) a0 += u[k] * Ai[k];
      } else {
        const int i = idx[s];
        const T x = xrow[i];
        const T* Ri = R + static_cast<size_t>(i) * l;
        const T* Wi = W + static_cast<size_t>(i) * l;
        for (; k + 32 < l; k += 64) {
          a0 += u[k] * row_elem(Ri[k], Wi[k], x, d[k]);
          a1 += u[k + 32] * row_elem(Ri[k + 32], Wi[k + 32], x, d[k + 32]);
        }
        if (k < l) a0 += u[k] * row_elem(Ri[k], Wi[k], x, d[k]);
      }
      const T acc = warp_sum(a0 + a1);
      if (lane == 0) vv[s] = acc;
    }
  };
  // q = sum_s vv[s]^2 into p[l] (warp 0)
  auto q_step = [&](T* p) {
    if (warp == 0) {
      T q = 0;
      for (int s = lane; s < m; s += 32) q += vv[s] * vv[s];
      q = warp_sum(q);
      if (lane == 0) p[l] = q;
    }
  };
  // the cluster's q, in rank order
  auto cluster_q = [&](T* p) {
    T q = 0;
    for (int r = 0; r < kCluster; ++r) q += cluster.map_shared_rank(p, r)[l];
    return q;
  };

  for (int t = 0; t < iters; ++t) {
    T* p = part + (t & 1) * (l + 1);
    v_step();
    __syncthreads();
    for (int k = tid; k < l; k += kThreads) {
      // four sums over the rows, for four loads in flight
      T a[4] = {0, 0, 0, 0};
      int s = 0;
      for (; s + 4 <= staged; s += 4) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          a[c] += vv[s + c] * rows[static_cast<size_t>(s + c) * l + k];
      }
      for (; s < staged; ++s)
        a[0] += vv[s] * rows[static_cast<size_t>(s) * l + k];
      const T dk = d[k];
      for (; s < m; ++s) {
        const int i = idx[s];
        const size_t ik = static_cast<size_t>(i) * l + k;
        a[1] += vv[s] * row_elem(R[ik], W[ik], xrow[i], dk);
      }
      p[k] = (a[0] + a[1]) + (a[2] + a[3]);
    }
    q_step(p);
    // every CTA's partials written; the other buffer is free again (its
    // readers passed this barrier after their last read of it)
    cluster.sync();
    const T nrm = clamp_min(sqrt_of(cluster_q(p)), T(1e-30));
    for (int k = tid; k < l; k += kThreads) {
      T acc = 0;
      for (int r = 0; r < kCluster; ++r)
        acc += cluster.map_shared_rank(p, r)[k];
      u[k] = acc / nrm;
    }
    __syncthreads();
  }

  // ---- sigma = |u|, u /= max(sigma, 1e-30), v = unit(u A)
  T q = 0;
  for (int k = tid; k < l; k += kThreads) q += u[k] * u[k];
  const T sigma = sqrt_of(block_sum(q, red));
  const T us = clamp_min(sigma, T(1e-30));
  bool ubad = false;
  for (int k = tid; k < l; k += kThreads) {
    const T uk = u[k] / us;
    u[k] = uk;
    if (!isfinite(uk)) ubad = true;
  }
  const bool u_nonfinite = __syncthreads_or(ubad) != 0;
  v_step();
  __syncthreads();
  T* p = part + (iters & 1) * (l + 1);
  q_step(p);
  cluster.sync();
  const T nrm = clamp_min(sqrt_of(cluster_q(p)), T(1e-30));
  for (int s = tid; s < m; s += kThreads) xo[idx[s]] = mul_rn(sigma, vv[s] / nrm);
  // a non-user's v is (u . 0) / |v|: 0, or NaN once u is not finite
  const T zero = mul_rn(mul_rn(sigma, (u_nonfinite ? nan_of(T()) : T(0)) / nrm),
                        T(0));
  for (int i = lo + tid; i < hi; i += kThreads)
    if (urow[i] == 0) xo[i] = zero;
  if (crank == 0)
    for (int k = tid; k < l; k += kThreads)
      u_out[static_cast<size_t>(j) * l + k] = u[k];
  // no CTA leaves while another may still read its partials
  cluster.sync();
}

template <typename T>
cudaError_t launch(const void* R, const void* W, const void* dj,
                   long long dj_s0, long long dj_s1, const void* xj,
                   const void* users, const void* rmax, void* u_out,
                   void* x_out, int b, int n, int l, int iters, int idx_cap,
                   int rows_cap, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ksvd_power_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  ksvd_power_kernel<T><<<b * kCluster, kThreads, smem, stream>>>(
      static_cast<const T*>(R), static_cast<const T*>(W),
      static_cast<const T*>(dj), dj_s0, dj_s1, static_cast<const T*>(xj),
      static_cast<const uint8_t*>(users), static_cast<const T*>(rmax),
      static_cast<T*>(u_out), static_cast<T*>(x_out), n, l, iters, idx_cap,
      rows_cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t max_clusters(int smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      ksvd_power_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(ksvd_power_kernel<T>), &cfg);
}

}  // namespace

extern "C" {

// Updates a block of b atoms on `stream`. R, W [n, l], xj [b, n], users
// [b, n] uint8 0/1, contiguous; dj [b, l] at element strides (dj_s0,
// dj_s1); rmax: max |R| as one value on the card. Writes u_out [b, l] and
// x_out [b, n]. dsize: 4 (float) or 8 (double). idx_cap = ceil(n /
// kCluster), rows_cap and smem from the wrapper's geometry. Returns a
// cudaError_t as int.
int ksvd_power_launch(const void* R, const void* W, const void* dj,
                      long long dj_s0, long long dj_s1, const void* xj,
                      const void* users, const void* rmax, void* u_out,
                      void* x_out, int b, int n, int l, int iters,
                      int idx_cap, int rows_cap, int smem, int dsize,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dsize == 4)
    return static_cast<int>(launch<float>(R, W, dj, dj_s0, dj_s1, xj, users,
                                          rmax, u_out, x_out, b, n, l, iters,
                                          idx_cap, rows_cap, smem, s));
  if (dsize == 8)
    return static_cast<int>(launch<double>(R, W, dj, dj_s0, dj_s1, xj, users,
                                           rmax, u_out, x_out, b, n, l, iters,
                                           idx_cap, rows_cap, smem, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of kCluster CTAs with `smem` bytes each the card runs
// at once (cudaOccupancyMaxActiveClusters), into *out.
int ksvd_power_max_clusters(int smem, int dsize, int* out) {
  if (dsize == 4) return static_cast<int>(max_clusters<float>(smem, out));
  if (dsize == 8) return static_cast<int>(max_clusters<double>(smem, out));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ksvd_power_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
