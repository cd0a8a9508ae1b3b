// Angle histogram of neighbor pairs per species triple (the ADF's second
// stage), for Hopper.
//
// Replaces the TPU kernel lammps_analysis_tpu/ops/pallas_adf.py::
// adf_pairs_histogram_pallas (:1482) with fold=True: for every frame, every
// center i whose species a lies in [0, S) and every unordered pair {j, k} of
// the first min(count_i, K) slots of its neighbor list (as
// csrc/adf_neighbor_extract.cu writes them) whose species lie in [0, S):
//   g     = xj*xk + yj*yk + zj*zk                      (left to right)
//   cos   = clamp(g / (dj*dk), -1, 1)                   (denominator 1 where 0)
//   theta = acosf(cos)
//   bin   = min(floor(theta * inv_bw), n_bins - 1)      (inv_bw = n_bins/3.15 in f32)
//   (b, c) = (min(sj, sk), max(sj, sk)); the pair is dropped when a > b
//   w     = (1 / (dj*dk))^p by squaring, doubled when sj == sk
// adds w to bin (triple_index(a, b, c), bin) of the frame's (n_triples,
// n_bins) float32 histogram. Each unordered pair once with weight 2 for equal
// species is the reference's ordered-pair count (j != k, non-decreasing
// triple) folded in half. Every step is an explicitly rounded intrinsic and
// the build passes -fmad=false, so each pair's bin and weight are those of
// the plain torch version in ops/adf.py (adf_pairs_histogram_reference), up to
// acosf's last ulp; the sums differ by the order of float32 atomic adds.
//
// Design. The TPU kernel ran each center's K x K tile through one-hot matrix
// products on the MXU, with the weight split into two bf16 halves. Here one
// warp takes one center at a time (a block of 8 warps walks 128 centers of
// one frame): it stages the center's m = min(count, K) entries in its slice
// of shared memory, then its lanes enumerate the m(m-1)/2 unordered pairs by
// a flat index q: pair (j, (j + dist) mod m) with dist = q / m + 1 and
// j = q mod m covers every unordered pair exactly once, with no idle lanes.
// Weights go to a block-private float32 histogram in dynamic shared memory
// (shared atomics), flushed into the frame's global histogram with float32
// atomics, non-zero bins only. A histogram beyond the shared-memory opt-in
// takes a second instantiation that adds straight into global memory.
//
// What bounds it on this card: about 7.7e7 pair evaluations at 16 x 10240
// atoms (~470 pairs per center at a first-shell cutoff), each an acosf, a
// division and a shared atomic that contends on a few thousand bins; the
// lists it reads (~20 bytes per slot) are a few hundred MB at most.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCentersPerBlock = 128;
constexpr int kStageFields = 5;  // x, y, z, d, species
constexpr int64_t kMaxGridY = 65535;

struct Params {
  int n_atoms, k_n, n_species, n_bins, n_total_bins, norm_power;
  float inv_bw;
};

__device__ __forceinline__ int triple_index(int a, int b, int c, int s) {
  const int sa = s - a;
  const int block_a = (s * (s + 1) * (s + 2) - sa * (sa + 1) * (sa + 2)) / 6;
  const int bb = b - a;
  return block_a + bb * sa - bb * (bb - 1) / 2 + (c - b);
}

__device__ __forceinline__ float int_power(float x, int e) {
  float result = 1.f;
  float base = x;
  while (e) {
    if (e & 1) result = __fmul_rn(result, base);
    e >>= 1;
    if (e) base = __fmul_rn(base, base);
  }
  return result;
}

template <bool kSharedHist>
__global__ void __launch_bounds__(kThreads)
adf_pairs_kernel(const float* __restrict__ rx, const float* __restrict__ ry,
                 const float* __restrict__ rz, const float* __restrict__ dd,
                 const int* __restrict__ sid_n, const int* __restrict__ counts,
                 const int* __restrict__ sid_c, float* __restrict__ out,
                 const Params p) {
  extern __shared__ float smem[];
  const int k = p.k_n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // histogram first (kSharedHist), then each warp's staging slice
  float* hist = smem;
  float* wx = smem + (kSharedHist ? p.n_total_bins : 0) +
              static_cast<int64_t>(warp) * kStageFields * k;
  float* wy = wx + k;
  float* wz = wy + k;
  float* wd = wz + k;
  int* ws = reinterpret_cast<int*>(wd + k);

  const int64_t frame_row = static_cast<int64_t>(blockIdx.y) * p.n_atoms;
  float* frame_out = out + static_cast<int64_t>(blockIdx.y) * p.n_total_bins;
  float* target = kSharedHist ? hist : frame_out;

  if (kSharedHist) {
    for (int b = threadIdx.x; b < p.n_total_bins; b += kThreads) hist[b] = 0.f;
    __syncthreads();
  }

  const int c_end = min(p.n_atoms, (static_cast<int>(blockIdx.x) + 1) * kCentersPerBlock);
  for (int c = blockIdx.x * kCentersPerBlock + warp; c < c_end; c += kWarps) {
    const int sa = sid_c[c];
    const int m = min(counts[frame_row + c], k);
    if (sa < 0 || sa >= p.n_species || m < 2) continue;  // warp-uniform
    const int64_t row = (frame_row + c) * k;
    for (int t = lane; t < m; t += 32) {
      wx[t] = rx[row + t];
      wy[t] = ry[row + t];
      wz[t] = rz[row + t];
      wd[t] = dd[row + t];
      const int s = sid_n[row + t];
      ws[t] = s >= 0 && s < p.n_species ? s : -1;
    }
    __syncwarp();
    const int n_pairs = m * (m - 1) / 2;
    for (int q = lane; q < n_pairs; q += 32) {
      const int dist = q / m + 1;
      const int j = q - (dist - 1) * m;
      const int kk = j + dist < m ? j + dist : j + dist - m;
      const int sj = ws[j], sk = ws[kk];
      const int b = min(sj, sk), cc = max(sj, sk);
      if (b < 0 || sa > b) continue;
      const float g = __fadd_rn(__fadd_rn(__fmul_rn(wx[j], wx[kk]), __fmul_rn(wy[j], wy[kk])),
                                __fmul_rn(wz[j], wz[kk]));
      float denom = __fmul_rn(wd[j], wd[kk]);
      denom = denom > 0.f ? denom : 1.f;
      const float cosv = fminf(fmaxf(__fdiv_rn(g, denom), -1.f), 1.f);
      const float theta = acosf(cosv);
      const int bin = min(static_cast<int>(floorf(__fmul_rn(theta, p.inv_bw))), p.n_bins - 1);
      float w = int_power(__frcp_rn(denom), p.norm_power);
      if (sj == sk) w = __fadd_rn(w, w);
      atomicAdd(&target[triple_index(sa, b, cc, p.n_species) * p.n_bins + bin], w);
    }
    __syncwarp();  // the slice is read before the next center restages it
  }

  if (kSharedHist) {
    __syncthreads();
    for (int b = threadIdx.x; b < p.n_total_bins; b += kThreads) {
      const float v = hist[b];
      if (v != 0.f) atomicAdd(&frame_out[b], v);
    }
  }
}

size_t stage_bytes(int64_t k_n) {
  return static_cast<size_t>(kWarps) * kStageFields * k_n * sizeof(float);
}

cudaError_t shared_limit(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *bytes = static_cast<size_t>(optin);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// 1 if an n_total_bins histogram with lists of width k_n takes the
// shared-memory path, 0 if it takes the global-atomics path, -1 if even the
// staging of k_n slots per warp exceeds the shared-memory opt-in, -2 on a
// CUDA error.
int adf_pairs_histogram_uses_shared(int64_t n_total_bins, int64_t k_n) {
  size_t limit = 0;
  if (shared_limit(&limit) != cudaSuccess) return -2;
  const size_t stage = stage_bytes(k_n);
  if (stage > limit) return -1;
  return stage + static_cast<size_t>(n_total_bins) * sizeof(float) <= limit ? 1 : 0;
}

// Adds the per-frame angle histograms of the neighbor lists rx, ry, rz, d
// (n_frames, n_atoms, k_n) float32, sid_n (n_frames, n_atoms, k_n) int32,
// counts (n_frames, n_atoms) int32 with center species sid_c (n_atoms,) int32
// into out (n_frames, n_triples * n_bins) float32, on `stream`. Allocates
// nothing and does not synchronise; returns cudaGetLastError().
int adf_pairs_histogram_launch(const void* rx, const void* ry, const void* rz,
                               const void* d, const void* sid_n,
                               const void* counts, const void* sid_c, void* out,
                               int64_t n_frames, int64_t n_atoms, int64_t k_n,
                               int64_t n_species, int64_t n_bins,
                               int64_t norm_power, float inv_bw, void* stream) {
  const int64_t n_triples = n_species * (n_species + 1) * (n_species + 2) / 6;
  const Params p{static_cast<int>(n_atoms), static_cast<int>(k_n),
                 static_cast<int>(n_species), static_cast<int>(n_bins),
                 static_cast<int>(n_triples * n_bins), static_cast<int>(norm_power),
                 inv_bw};
  size_t limit = 0;
  cudaError_t err = shared_limit(&limit);
  if (err != cudaSuccess) return err;
  const size_t stage = stage_bytes(k_n);
  if (stage > limit) return cudaErrorInvalidValue;
  const size_t hist_bytes = static_cast<size_t>(p.n_total_bins) * sizeof(float);
  const bool shared = stage + hist_bytes <= limit;
  const size_t smem = shared ? stage + hist_bytes : stage;
  if (shared) {
    err = cudaFuncSetAttribute(adf_pairs_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  } else {
    err = cudaFuncSetAttribute(adf_pairs_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks =
      static_cast<unsigned int>((n_atoms + kCentersPerBlock - 1) / kCentersPerBlock);
  const int64_t list = n_atoms * k_n;
  for (int64_t f0 = 0; f0 < n_frames; f0 += kMaxGridY) {
    const dim3 grid(blocks, static_cast<unsigned int>(
                                n_frames - f0 < kMaxGridY ? n_frames - f0 : kMaxGridY));
    const float* fx = static_cast<const float*>(rx) + f0 * list;
    const float* fy = static_cast<const float*>(ry) + f0 * list;
    const float* fz = static_cast<const float*>(rz) + f0 * list;
    const float* fd = static_cast<const float*>(d) + f0 * list;
    const int* fs = static_cast<const int*>(sid_n) + f0 * list;
    const int* fc = static_cast<const int*>(counts) + f0 * n_atoms;
    const int* sc = static_cast<const int*>(sid_c);
    float* fo = static_cast<float*>(out) + f0 * n_triples * n_bins;
    if (shared) {
      adf_pairs_kernel<true><<<grid, kThreads, smem, s>>>(fx, fy, fz, fd, fs, fc, sc, fo, p);
    } else {
      adf_pairs_kernel<false><<<grid, kThreads, smem, s>>>(fx, fy, fz, fd, fs, fc, sc, fo, p);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
