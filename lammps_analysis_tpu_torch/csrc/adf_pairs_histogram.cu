// Angle histogram of neighbor pairs per species triple (the ADF's second
// stage), for Hopper.
//
// Replaces the TPU kernel lammps_analysis_tpu/ops/pallas_adf.py::
// adf_pairs_histogram_pallas (:1482) with fold=True: for every frame, every
// center i whose species a lies in [0, S) and every unordered pair {j, k} of
// the first m = min(count_i, K) slots of its neighbor list (as the neighbor
// extract writes them) whose species lie in [0, S):
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
// Pair order. A center's m(m-1)/2 unordered pairs are the TPU kernel's fold
// rows laid end to end: flat index q is row d = 1 + q / m, column j = q mod
// m, pair (j, (j + d) mod m); rows d < m/2 are whole, and at even m the last
// row d = m/2 stops after m/2 columns, so every pair comes once. The lanes of
// a warp take q = q0 + lane, q0 + lane + 32, ...; each lane divides once to
// place its first pair and then steps by 32 = step * m + rem with adds and
// one compare, so the pair loop has no division.
//
// Entries. A list of at most kStage entries is staged by its warp in shared
// memory, and only the entries a pair can keep (species in [a, S)), in slot
// order (ballot and popcount): every staged pair is then kept, so no lane
// idles on a pair dropped for its species (with 2 species, 3 in 4 of the
// pairs of a center of species 1). Wider lists are read from global memory
// (L1/L2), where each entry serves hundreds of pairs, and drop pairs one by
// one.
//
// Work split. A unit is (center, chunk): chunk c of a center covers its flat
// pairs [c * chunk_pairs, (c + 1) * chunk_pairs), and every center has
// chunks_per_center units (from K, on the host: ops/adf_kernel.py::
// pairs_split), of which those beyond its own pairs are empty. A frame's
// units are dealt round-robin to the warps of its blocks (unit u to warp u
// mod warps, the chunk count prime to the warps, so the first chunks of
// narrow centers spread over all of them); each lane of a warp reads the
// count of one of the warp's next 32 units at once and a ballot keeps the
// live ones, so empty units cost almost nothing. A wide list is cut into
// chunks that land on consecutive warps, in different blocks and on
// different SMs. The host sizes the grid from the kernel's occupancy so that
// one wave of blocks covers every SM (blocks per frame, frames as grid y).
//
// Sums. Each block adds into a float64 histogram in shared memory (or, when
// n_triples * n_bins doubles do not fit there beside the stages, straight
// into the frame's float64 accumulator in global memory), flushes its
// non-zero bins into the accumulator with float64 atomics, and counts itself
// done for its frame behind a __threadfence; the frame's last block rounds
// the accumulator into the float32 output. One accumulator type at every K:
// a wide list puts ~K^2 / 2 weights of one center on a few bins, and float32
// bins drifted beyond the ADF's rtol 1e-5 at K ~ 1650. On sm_90a the shared
// float64 atomicAdd is a compare-and-swap loop (ATOMS.CAST.SPIN.64, about 6
// instructions with its load and compare); a racy plain add, timed only,
// was not enough faster to pay for private histograms, which would cut the
// warps an SM holds. A call is a memset of the accumulator and the done
// counters, then this one kernel.
//
// What bounds it on this card: about 4.8e6 pair evaluations a frame at
// 10240 atoms and a first-shell cutoff, each about 140 issued instructions
// (a division, a reciprocal and an acosf, all rounded as the plain version
// rounds them, and the float64 add): instruction issue, not bytes (the lists
// are ~20 bytes a slot). Tensor cores do not apply: the angle needs each
// pair's float32 dot product rounded as the plain version rounds it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 3;  // 40 registers a thread
constexpr int kStage = 128;  // entries a warp stages
constexpr int kStageBytes = kWarps * kStage * 16;  // the float4s; the species take a quarter more
constexpr size_t kSmemFixed = kStageBytes + kStageBytes / 4;
constexpr int64_t kMaxGridY = 65535;

struct Params {
  int n_atoms, k_n, n_species, n_bins, n_total_bins, norm_power;
  float inv_bw;
  int chunk_pairs;        // pairs of one unit
  int chunks_per_center;  // units of one center
};

// Index of the non-decreasing triple (a, b, c) among the S species' triples:
// triple_start(a) triples start with a species below a, then (b, c) count on.
__device__ __forceinline__ int triple_start(int a, int s) {
  const int sa = s - a;
  return (s * (s + 1) * (s + 2) - sa * (sa + 1) * (sa + 2)) / 6;
}

__device__ __forceinline__ int triple_index(int tri_a, int a, int b, int c, int s) {
  const int bb = b - a;
  return tri_a + bb * (s - a) - bb * (bb - 1) / 2 + (c - b);
}

// x^e by squaring, the plain version's order of multiplications (1 * x is
// x exactly); the exponents below 8 unrolled without branches (with the
// 32-bit divisions of the unit decode, a few per cent of every case on the
// card against a plain loop and 64-bit divisions).
__device__ __forceinline__ float int_power(float x, int e) {
  float result = 1.f;
  float base = x;
  if (e < 8) {
#pragma unroll
    for (int bit = 0; bit < 3; ++bit) {
      if (e & (1 << bit)) result = __fmul_rn(result, base);
      base = __fmul_rn(base, base);
    }
    return result;
  }
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

// A warp's copy of one center's entries in shared memory: (x, y, z, d) and
// the species (-1 for padding), kStage slots.
struct Stage {
  float4* entry;
  int* species;
};

// The histogram slot of the pair (ej, sj), (ek, sk) of a center of species
// sa (tri_a = triple_start(sa)) and its weight; -1 when the pair is dropped.
__device__ __forceinline__ int pair_slot(float4 ej, float4 ek, int sj, int sk, int sa, int tri_a,
                                         const Params& p, float* weight) {
  const int b = min(sj, sk), cc = max(sj, sk);
  if (b < 0 || sa > b) return -1;
  const float g = __fadd_rn(__fadd_rn(__fmul_rn(ej.x, ek.x), __fmul_rn(ej.y, ek.y)),
                            __fmul_rn(ej.z, ek.z));
  float denom = __fmul_rn(ej.w, ek.w);
  denom = denom > 0.f ? denom : 1.f;
  const float cosv = fminf(fmaxf(__fdiv_rn(g, denom), -1.f), 1.f);
  const float theta = acosf(cosv);
  const int bin = min(static_cast<int>(floorf(__fmul_rn(theta, p.inv_bw))), p.n_bins - 1);
  const float w = int_power(__frcp_rn(denom), p.norm_power);
  *weight = sj == sk ? __fadd_rn(w, w) : w;
  return triple_index(tri_a, sa, b, cc, p.n_species) * p.n_bins + bin;
}

// Adds the angles of the n flat pairs from flat index q0 on of one center's
// m entries into target; called by all 32 lanes of a warp. kStaged: the
// entries are in the warp's stage, else read from the lists in global memory
// (ex..es).
template <bool kStaged>
__device__ __forceinline__ void add_chunk(const float* __restrict__ ex,
                                          const float* __restrict__ ey,
                                          const float* __restrict__ ez,
                                          const float* __restrict__ ed,
                                          const int* __restrict__ es, Stage st, int m,
                                          int64_t q0, int n, int sa, const Params& p,
                                          double* target, int lane) {
  if (lane >= n) return;
  // this lane's first pair, q0 + lane: row d, column j
  int d = static_cast<int>(q0 <= INT32_MAX ? static_cast<int>(q0) / m : q0 / m);
  int j = static_cast<int>(q0 - static_cast<int64_t>(d) * m) + lane;
  ++d;
  int step = 0, rem = 32;
  if (m > 32) {
    if (j >= m) {
      j -= m;
      ++d;
    }
  } else {  // warp-uniform
    step = 32 / m;
    rem = 32 - step * m;
    const int rows = j / m;
    j -= rows * m;
    d += rows;
  }
  const int tri_a = triple_start(sa, p.n_species);
  for (int r = lane; r < n; r += 32) {
    int kk = j + d;
    kk = kk < m ? kk : kk - m;
    float w;
    const int slot =
        kStaged
            ? pair_slot(st.entry[j], st.entry[kk], st.species[j], st.species[kk], sa, tri_a, p, &w)
            : pair_slot(make_float4(__ldg(ex + j), __ldg(ey + j), __ldg(ez + j), __ldg(ed + j)),
                        make_float4(__ldg(ex + kk), __ldg(ey + kk), __ldg(ez + kk), __ldg(ed + kk)),
                        species_or_pad(__ldg(es + j), p.n_species),
                        species_or_pad(__ldg(es + kk), p.n_species), sa, tri_a, p, &w);
    if (slot >= 0) atomicAdd(&target[slot], static_cast<double>(w));
    j += rem;
    d += step;
    if (j >= m) {
      j -= m;
      ++d;
    }
  }
}

// One launch chunk of frames (grid y). acc (frames, n_total_bins) float64 and
// done (frames,) uint32 are zero on entry; out (frames, n_total_bins) float32.
template <bool kSharedHist>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
adf_pairs_kernel(const float* __restrict__ rx, const float* __restrict__ ry,
                 const float* __restrict__ rz, const float* __restrict__ dd,
                 const int* __restrict__ sid_n, const int* __restrict__ counts,
                 const int* __restrict__ sid_c, double* __restrict__ acc,
                 unsigned int* __restrict__ done, float* __restrict__ out,
                 const Params p) {
  // each warp's stage, then (kSharedHist) the float64 histogram
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Stage stage{reinterpret_cast<float4*>(smem) + warp * kStage,
                    reinterpret_cast<int*>(smem + kStageBytes) + warp * kStage};
  double* hist_smem = reinterpret_cast<double*>(smem + kStageBytes + kStageBytes / 4);
  const int frame = blockIdx.y;
  const int64_t frame_row = static_cast<int64_t>(frame) * p.n_atoms;
  double* frame_acc = acc + static_cast<int64_t>(frame) * p.n_total_bins;
  double* target = kSharedHist ? hist_smem : frame_acc;

  if (kSharedHist) {
    for (int b = threadIdx.x; b < p.n_total_bins; b += kThreads) hist_smem[b] = 0.0;
    __syncthreads();
  }

  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t n_units = static_cast<int64_t>(p.n_atoms) * p.chunks_per_center;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       base < n_units; base += 32 * n_warps) {
    // lane l looks at the warp's unit base + l * n_warps
    const int64_t u = base + lane * n_warps;
    int center = 0, chunk = 0, sa = -1, m = 0;
    bool live = false;
    if (u < n_units) {
      if (p.chunks_per_center == 1) {
        center = static_cast<int>(u);
      } else if (n_units <= INT32_MAX) {
        center = static_cast<int>(u) / p.chunks_per_center;
        chunk = static_cast<int>(u) - center * p.chunks_per_center;
      } else {
        center = static_cast<int>(u / p.chunks_per_center);
        chunk = static_cast<int>(u - static_cast<int64_t>(center) * p.chunks_per_center);
      }
      sa = species_or_pad(__ldg(sid_c + center), p.n_species);
      m = min(__ldg(counts + frame_row + center), p.k_n);
      live = sa >= 0 && static_cast<int64_t>(m) * (m - 1) / 2 > static_cast<int64_t>(chunk) * p.chunk_pairs;
    }
    for (unsigned int todo = __ballot_sync(0xffffffffu, live); todo; todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const int64_t row = (frame_row + __shfl_sync(0xffffffffu, center, src)) * p.k_n;
      int um = __shfl_sync(0xffffffffu, m, src);
      const int64_t q0 = static_cast<int64_t>(__shfl_sync(0xffffffffu, chunk, src)) * p.chunk_pairs;
      const int usa = __shfl_sync(0xffffffffu, sa, src);
      const float *ex = rx + row, *ey = ry + row, *ez = rz + row, *ed = dd + row;
      const int* es = sid_n + row;
      const bool staged = um <= kStage;  // warp-uniform
      if (staged) {
        // stage the entries a pair of this center can keep (species >= usa),
        // in order: every pair of the stage is kept, so no lane idles on a
        // dropped pair
        int kept = 0;
        for (int t0 = 0; t0 < um; t0 += 32) {
          const int t = t0 + lane;
          const int st = t < um ? species_or_pad(__ldg(es + t), p.n_species) : -1;
          const unsigned int keep = __ballot_sync(0xffffffffu, st >= usa);
          if (st >= usa) {
            const int at = kept + __popc(keep & ((1u << lane) - 1));
            stage.entry[at] = make_float4(__ldg(ex + t), __ldg(ey + t), __ldg(ez + t), __ldg(ed + t));
            stage.species[at] = st;
          }
          kept += __popc(keep);
        }
        um = kept;
        __syncwarp();
      }
      const int64_t left = static_cast<int64_t>(um) * (um - 1) / 2 - q0;
      if (left > 0) {
        const int n = static_cast<int>(left < p.chunk_pairs ? left : p.chunk_pairs);
        if (staged) {
          add_chunk<true>(ex, ey, ez, ed, es, stage, um, q0, n, usa, p, target, lane);
        } else {
          add_chunk<false>(ex, ey, ez, ed, es, stage, um, q0, n, usa, p, target, lane);
        }
      }
      if (staged) __syncwarp();  // read before the next unit restages
    }
  }

  if (kSharedHist) {
    __syncthreads();
    for (int b = threadIdx.x; b < p.n_total_bins; b += kThreads) {
      const double v = hist_smem[b];
      if (v != 0.0) atomicAdd(&frame_acc[b], v);
    }
  }
  // the frame's last block to finish rounds its accumulator
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_block = atomicAdd(&done[frame], 1u) == gridDim.x - 1;
  __syncthreads();
  if (last_block) {
    __threadfence();
    float* frame_out = out + static_cast<int64_t>(frame) * p.n_total_bins;
    for (int b = threadIdx.x; b < p.n_total_bins; b += kThreads) {
      frame_out[b] = __double2float_rn(__ldcg(&frame_acc[b]));
    }
  }
}

cudaError_t device_limits(size_t* smem_optin, int* n_sms) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  *smem_optin = static_cast<size_t>(optin);
  return err;
}

// The histogram goes to shared memory when it fits a block's opt-in beside
// the stages.
bool shared_hist(int64_t n_total_bins, size_t smem_optin) {
  return kSmemFixed + static_cast<size_t>(n_total_bins) * sizeof(double) <= smem_optin;
}

size_t smem_bytes(bool in_shared, int64_t n_total_bins) {
  return kSmemFixed + (in_shared ? static_cast<size_t>(n_total_bins) * sizeof(double) : 0);
}

template <bool kSharedHist>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(adf_pairs_kernel<kSharedHist>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

template <bool kSharedHist>
cudaError_t launch_frames(size_t smem, int64_t blocks_per_frame, const float* rx,
                          const float* ry, const float* rz, const float* d,
                          const int* sid_n, const int* counts, const int* sid_c,
                          double* acc, unsigned int* done, float* out, int64_t n_frames,
                          const Params& p, cudaStream_t s) {
  cudaError_t err = set_smem<kSharedHist>(smem);
  if (err != cudaSuccess) return err;
  const int64_t list = static_cast<int64_t>(p.n_atoms) * p.k_n;
  for (int64_t f0 = 0; f0 < n_frames; f0 += kMaxGridY) {
    const dim3 grid(static_cast<unsigned int>(blocks_per_frame),
                    static_cast<unsigned int>(n_frames - f0 < kMaxGridY ? n_frames - f0 : kMaxGridY));
    adf_pairs_kernel<kSharedHist><<<grid, kThreads, smem, s>>>(
        rx + f0 * list, ry + f0 * list, rz + f0 * list, d + f0 * list, sid_n + f0 * list,
        counts + f0 * p.n_atoms, sid_c, acc + f0 * p.n_total_bins, done + f0,
        out + f0 * p.n_total_bins, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// What the angle kernel takes for an n_total_bins histogram on the current
// device: *shared 1 when the float64 histogram lives in shared memory, 0 when
// the adds go to global memory; *blocks_per_sm the blocks of kWarps warps one
// SM holds at once; *n_sms the device's SMs; *warps kWarps. A CUDA error code.
int adf_pairs_histogram_shape(int64_t n_total_bins, int* shared, int* blocks_per_sm,
                              int* n_sms, int* warps) {
  size_t optin = 0;
  cudaError_t err = device_limits(&optin, n_sms);
  if (err != cudaSuccess) return err;
  *shared = shared_hist(n_total_bins, optin) ? 1 : 0;
  *warps = kWarps;
  const size_t smem = smem_bytes(*shared, n_total_bins);
  err = *shared ? set_smem<true>(smem) : set_smem<false>(smem);
  if (err != cudaSuccess) return err;
  return *shared ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       blocks_per_sm, adf_pairs_kernel<true>, kThreads, smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       blocks_per_sm, adf_pairs_kernel<false>, kThreads, smem);
}

// Writes the per-frame angle histograms of the neighbor lists rx, ry, rz, d
// (n_frames, n_atoms, k_n) float32, sid_n (n_frames, n_atoms, k_n) int32,
// counts (n_frames, n_atoms) int32 with center species sid_c (n_atoms,) int32
// into out (n_frames, n_triples * n_bins) float32, on `stream`. scratch holds
// n_frames * n_triples * n_bins doubles then n_frames uint32 (cleared here).
// Each center's pairs are cut into chunks_per_center units of chunk_pairs
// pairs; blocks_per_frame blocks of kWarps warps take a frame's units
// (ops/adf_kernel.py::pairs_split). Allocates nothing and does not
// synchronise; returns cudaGetLastError().
int adf_pairs_histogram_launch(const void* rx, const void* ry, const void* rz,
                               const void* d, const void* sid_n,
                               const void* counts, const void* sid_c, void* out,
                               void* scratch, int64_t n_frames, int64_t n_atoms, int64_t k_n,
                               int64_t n_species, int64_t n_bins, int64_t norm_power,
                               float inv_bw, int64_t chunk_pairs, int64_t chunks_per_center,
                               int64_t blocks_per_frame, void* stream) {
  const int64_t n_triples = n_species * (n_species + 1) * (n_species + 2) / 6;
  const Params p{static_cast<int>(n_atoms), static_cast<int>(k_n),
                 static_cast<int>(n_species), static_cast<int>(n_bins),
                 static_cast<int>(n_triples * n_bins), static_cast<int>(norm_power),
                 inv_bw, static_cast<int>(chunk_pairs), static_cast<int>(chunks_per_center)};
  size_t optin = 0;
  int n_sms = 0;
  cudaError_t err = device_limits(&optin, &n_sms);
  if (err != cudaSuccess) return err;
  const bool in_shared = shared_hist(p.n_total_bins, optin);
  const size_t smem = smem_bytes(in_shared, p.n_total_bins);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = n_frames * p.n_total_bins;
  auto* acc = static_cast<double*>(scratch);
  auto* done = reinterpret_cast<unsigned int*>(acc + n_out);
  err = cudaMemsetAsync(acc, 0, static_cast<size_t>(n_out) * sizeof(double) +
                                    static_cast<size_t>(n_frames) * sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  const auto* fx = static_cast<const float*>(rx);
  const auto* fy = static_cast<const float*>(ry);
  const auto* fz = static_cast<const float*>(rz);
  const auto* fd = static_cast<const float*>(d);
  const auto* fs = static_cast<const int*>(sid_n);
  const auto* fc = static_cast<const int*>(counts);
  const auto* sc = static_cast<const int*>(sid_c);
  auto* fo = static_cast<float*>(out);
  return in_shared
             ? launch_frames<true>(smem, blocks_per_frame, fx, fy, fz, fd, fs, fc, sc, acc, done,
                                   fo, n_frames, p, s)
             : launch_frames<false>(smem, blocks_per_frame, fx, fy, fz, fd, fs, fc, sc, acc, done,
                                    fo, n_frames, p, s);
}

}  // extern "C"
