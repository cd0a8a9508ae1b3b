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
// n_bins) histogram, summed in float64 and rounded to float32 at the end, as
// the plain version sums. Each unordered pair once with weight 2 for equal
// species is the reference's ordered-pair count (j != k, non-decreasing
// triple) folded in half. Every step is an explicitly rounded intrinsic and
// the build passes -fmad=false, so each pair's bin and weight are those of
// the plain torch version in ops/adf.py (adf_pairs_histogram_reference), up to
// acosf's last ulp; the float64 sums differ only by the order of the adds.
//
// Design. The TPU kernel ran each center's K x K tile through one-hot matrix
// products on the MXU, with the weight split into two bf16 halves. Here one
// warp takes one center at a time (a block of 8 warps walks 128 centers of
// one frame): its lanes enumerate the m(m-1)/2 unordered pairs of the
// center's m = min(count, K) entries by a flat index q: pair (j, (j + dist)
// mod m) with dist = q / m + 1 and j = q mod m covers every unordered pair
// exactly once, with no idle lanes (q is 64-bit when m(m-1)/2 would pass
// 2^31). Weights go to a block-private float64 histogram in dynamic shared
// memory (shared atomics), flushed into the frame's float64 accumulator in
// global memory (float64 atomics, non-zero bins only); a last kernel rounds
// the accumulator into the float32 output. One accumulator type at every K:
// a wide list puts ~K^2 / 2 weights of one center on a few bins, and float32
// bins drifted beyond the ADF's rtol 1e-5 at K ~ 1650.
//
// Instantiations, chosen by what fits a block's shared-memory opt-in: the
// entries staged per warp in shared memory (8 warps x 5 x K x 4 bytes) and
// the histogram there too; then the histogram alone, the warp reading its
// center's entries straight from global memory (20 bytes x K, in L2); then
// the staging alone with the pairs added straight into the global float64
// accumulator; then neither. So any K, up to the atom count, and any
// histogram size run on the card.
//
// What bounds it on this card: about 7.7e7 pair evaluations at 16 x 10240
// atoms (~470 pairs per center at a first-shell cutoff), each an acosf, a
// division and a shared atomic that contends on a few thousand bins; the
// lists it reads (~20 bytes per slot) are a few hundred MB at most. Tensor
// cores do not apply: the angle needs each pair's float32 dot product
// rounded as the plain version rounds it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCentersPerBlock = 128;
constexpr int kStageFields = 5;  // x, y, z, d, species
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kFinishBlocks = 1056;  // 8 blocks of 256 threads on each of 132 SMs

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

__device__ __forceinline__ int species_or_pad(int s, int n_species) {
  return s >= 0 && s < n_species ? s : -1;
}

// Adds the angles of every unordered pair of one center's m entries (ex..es)
// into target; called by all 32 lanes of a warp.
template <typename Index>
__device__ __forceinline__ void center_pairs(const float* ex, const float* ey,
                                             const float* ez, const float* ed,
                                             const int* es, int m, int sa,
                                             const Params& p, double* target,
                                             int lane) {
  const Index n_pairs = static_cast<Index>(m) * (m - 1) / 2;
  for (Index q = lane; q < n_pairs; q += 32) {
    const Index dist = q / m + 1;
    const int j = static_cast<int>(q - (dist - 1) * m);
    const int kk = static_cast<int>(j + dist < m ? j + dist : j + dist - m);
    const int sj = species_or_pad(es[j], p.n_species);
    const int sk = species_or_pad(es[kk], p.n_species);
    const int b = min(sj, sk), cc = max(sj, sk);
    if (b < 0 || sa > b) continue;
    const float g = __fadd_rn(__fadd_rn(__fmul_rn(ex[j], ex[kk]), __fmul_rn(ey[j], ey[kk])),
                              __fmul_rn(ez[j], ez[kk]));
    float denom = __fmul_rn(ed[j], ed[kk]);
    denom = denom > 0.f ? denom : 1.f;
    const float cosv = fminf(fmaxf(__fdiv_rn(g, denom), -1.f), 1.f);
    const float theta = acosf(cosv);
    const int bin = min(static_cast<int>(floorf(__fmul_rn(theta, p.inv_bw))), p.n_bins - 1);
    float w = int_power(__frcp_rn(denom), p.norm_power);
    if (sj == sk) w = __fadd_rn(w, w);
    atomicAdd(&target[triple_index(sa, b, cc, p.n_species) * p.n_bins + bin], static_cast<double>(w));
  }
}

// Adds the frames' pair weights into acc (n_frames, n_total_bins) float64.
template <bool kSharedHist, bool kStaged>
__global__ void __launch_bounds__(kThreads)
adf_pairs_kernel(const float* __restrict__ rx, const float* __restrict__ ry,
                 const float* __restrict__ rz, const float* __restrict__ dd,
                 const int* __restrict__ sid_n, const int* __restrict__ counts,
                 const int* __restrict__ sid_c, double* __restrict__ acc,
                 const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = p.k_n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // histogram first (kSharedHist), then each warp's staging slice (kStaged)
  double* hist = reinterpret_cast<double*>(smem);
  float* wx = reinterpret_cast<float*>(smem + (kSharedHist ? p.n_total_bins * sizeof(double) : 0)) +
              static_cast<int64_t>(warp) * kStageFields * k;
  float* wy = wx + k;
  float* wz = wy + k;
  float* wd = wz + k;
  int* ws = reinterpret_cast<int*>(wd + k);

  const int64_t frame_row = static_cast<int64_t>(blockIdx.y) * p.n_atoms;
  double* frame_acc = acc + static_cast<int64_t>(blockIdx.y) * p.n_total_bins;

  if (kSharedHist) {
    for (int b = threadIdx.x; b < p.n_total_bins; b += kThreads) hist[b] = 0.0;
    __syncthreads();
  }

  const int c_end = min(p.n_atoms, (static_cast<int>(blockIdx.x) + 1) * kCentersPerBlock);
  for (int c = blockIdx.x * kCentersPerBlock + warp; c < c_end; c += kWarps) {
    const int sa = sid_c[c];
    const int m = min(counts[frame_row + c], k);
    if (sa < 0 || sa >= p.n_species || m < 2) continue;  // warp-uniform
    const int64_t row = (frame_row + c) * k;
    const float *ex = rx + row, *ey = ry + row, *ez = rz + row, *ed = dd + row;
    const int* es = sid_n + row;
    if (kStaged) {
      for (int t = lane; t < m; t += 32) {
        wx[t] = ex[t];
        wy[t] = ey[t];
        wz[t] = ez[t];
        wd[t] = ed[t];
        ws[t] = es[t];
      }
      __syncwarp();
      ex = wx, ey = wy, ez = wz, ed = wd, es = ws;
    }
    double* target = kSharedHist ? hist : frame_acc;
    if (m <= 46340) {  // m(m-1)/2 < 2^31
      center_pairs<int>(ex, ey, ez, ed, es, m, sa, p, target, lane);
    } else {
      center_pairs<int64_t>(ex, ey, ez, ed, es, m, sa, p, target, lane);
    }
    if (kStaged) __syncwarp();  // the slice is read before the next center restages it
  }

  if (kSharedHist) {
    __syncthreads();
    for (int b = threadIdx.x; b < p.n_total_bins; b += kThreads) {
      const double v = hist[b];
      if (v != 0.0) atomicAdd(&frame_acc[b], v);
    }
  }
}

// out[i] = acc[i] rounded to float32 (to nearest, as the plain version's
// float64 -> float32 conversion).
__global__ void __launch_bounds__(256)
adf_pairs_finish(const double* __restrict__ acc, float* __restrict__ out, int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * 256) {
    out[i] = __double2float_rn(acc[i]);
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

// Which instantiation takes a histogram of n_total_bins with lists of width
// k_n, and the dynamic shared memory it uses. The histogram in shared memory
// comes before the staging: its atomics cost more than reading the entries
// from L2.
struct Route {
  bool shared_hist, staged;
  size_t smem;
};

Route choose(int64_t n_total_bins, int64_t k_n, size_t limit) {
  const size_t stage = stage_bytes(k_n);
  const size_t hist = static_cast<size_t>(n_total_bins) * sizeof(double);
  if (stage + hist <= limit) return {true, true, stage + hist};
  if (hist <= limit) return {true, false, hist};
  if (stage <= limit) return {false, true, stage};
  return {false, false, 0};
}

template <bool kSharedHist, bool kStaged>
cudaError_t launch_frames(const Route& r, const float* rx, const float* ry,
                          const float* rz, const float* d, const int* sid_n,
                          const int* counts, const int* sid_c, double* acc,
                          int64_t n_frames, const Params& p, cudaStream_t s) {
  auto kernel = adf_pairs_kernel<kSharedHist, kStaged>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(r.smem));
  if (err != cudaSuccess) return err;
  const unsigned int blocks =
      static_cast<unsigned int>((p.n_atoms + kCentersPerBlock - 1) / kCentersPerBlock);
  const int64_t list = static_cast<int64_t>(p.n_atoms) * p.k_n;
  for (int64_t f0 = 0; f0 < n_frames; f0 += kMaxGridY) {
    const dim3 grid(blocks, static_cast<unsigned int>(
                                n_frames - f0 < kMaxGridY ? n_frames - f0 : kMaxGridY));
    kernel<<<grid, kThreads, r.smem, s>>>(
        rx + f0 * list, ry + f0 * list, rz + f0 * list, d + f0 * list,
        sid_n + f0 * list, counts + f0 * p.n_atoms, sid_c,
        acc + f0 * p.n_total_bins, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bit 0: an n_total_bins histogram with lists of width k_n is kept in shared
// memory; bit 1: the entries are staged there. -2 on a CUDA error.
int adf_pairs_histogram_route(int64_t n_total_bins, int64_t k_n) {
  size_t limit = 0;
  if (shared_limit(&limit) != cudaSuccess) return -2;
  const Route r = choose(n_total_bins, k_n, limit);
  return (r.shared_hist ? 1 : 0) | (r.staged ? 2 : 0);
}

// Writes the per-frame angle histograms of the neighbor lists rx, ry, rz, d
// (n_frames, n_atoms, k_n) float32, sid_n (n_frames, n_atoms, k_n) int32,
// counts (n_frames, n_atoms) int32 with center species sid_c (n_atoms,) int32
// into out (n_frames, n_triples * n_bins) float32, on `stream`, summing in
// acc, float64 scratch of out's size (cleared here). Allocates nothing and
// does not synchronise; returns cudaGetLastError().
int adf_pairs_histogram_launch(const void* rx, const void* ry, const void* rz,
                               const void* d, const void* sid_n,
                               const void* counts, const void* sid_c, void* out,
                               void* acc, int64_t n_frames, int64_t n_atoms, int64_t k_n,
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
  const Route r = choose(p.n_total_bins, k_n, limit);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fx = static_cast<const float*>(rx);
  const auto* fy = static_cast<const float*>(ry);
  const auto* fz = static_cast<const float*>(rz);
  const auto* fd = static_cast<const float*>(d);
  const auto* fs = static_cast<const int*>(sid_n);
  const auto* fc = static_cast<const int*>(counts);
  const auto* sc = static_cast<const int*>(sid_c);
  auto* fa = static_cast<double*>(acc);
  const int64_t n_out = n_frames * p.n_total_bins;
  err = cudaMemsetAsync(fa, 0, static_cast<size_t>(n_out) * sizeof(double), s);
  if (err != cudaSuccess) return err;
  if (r.shared_hist && r.staged) {
    err = launch_frames<true, true>(r, fx, fy, fz, fd, fs, fc, sc, fa, n_frames, p, s);
  } else if (r.shared_hist) {
    err = launch_frames<true, false>(r, fx, fy, fz, fd, fs, fc, sc, fa, n_frames, p, s);
  } else if (r.staged) {
    err = launch_frames<false, true>(r, fx, fy, fz, fd, fs, fc, sc, fa, n_frames, p, s);
  } else {
    err = launch_frames<false, false>(r, fx, fy, fz, fd, fs, fc, sc, fa, n_frames, p, s);
  }
  if (err != cudaSuccess) return err;
  const int64_t finish_blocks = (n_out + 255) / 256 < kFinishBlocks ? (n_out + 255) / 256 : kFinishBlocks;
  adf_pairs_finish<<<static_cast<unsigned int>(finish_blocks), 256, 0, s>>>(
      fa, static_cast<float*>(out), n_out);
  return cudaGetLastError();
}

}  // extern "C"
