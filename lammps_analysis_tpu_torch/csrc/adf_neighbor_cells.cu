// Per-center neighbor lists inside a cutoff over cell lists (the ADF's first
// stage, binned route), for Hopper.
//
// Replaces the TPU kernel lammps_analysis_tpu/ops/pallas_adf.py::
// _neighbor_extract_pallas (:221) on the path that the JAX package sends
// through cell lists (ops/cells.py::neighbor_lists_cells, binned in XLA). The
// contract is csrc/adf_neighbor_extract.cu's, and ops/adf.py::
// neighbor_extract_reference is the plain version of both: for every frame and
// every center i with a species id in [0, S), every atom j != i with a species
// id in [0, S) and minimum-image distance d < cutoff, in ascending j, in K slots
// of structure-of-arrays outputs (F, N, K): rx, ry, rz, d (float32, r = pos_j -
// pos_i), sid (int32), empty slots 0 and sid -1; counts (F, N) int32 the TRUE
// count; and, when the caller asks for it (the TPU kernel's lean=False, reached
// through neighbor_indices_pallas :1395), idx (F, N, K) int32, the neighbors'
// atom indices in the same slots, -1 in empty ones. A center with more than K neighbors gets its exact count and K of
// its neighbors, in an unspecified choice (the caller retries with a wider K).
// The arithmetic is the sweep's (csrc/pair_math.cuh), on the stored,
// unwrapped coordinates, so every value equals the plain version's bit for
// bit; the cutoff test is s <= t (ops/geometry.py::squared_cutoff).
//
// Design, per frame of the launch:
// 1. bin: each atom's cell from its position wrapped into the box in float64,
//    used for the binning alone (f = x / L; f -= floor(f); c = min(floor(f *
//    n), n - 1), as ops/cells.py::cell_of_atoms computes it); padding goes to
//    one cell past the real ones. An atomic count per cell gives each atom its
//    rank in its cell (in no fixed order: the per-center sort below fixes the
//    output order);
// 2. scan: one block per frame turns the counts into cell starts;
// 3. scatter: atoms go to their cell's run as float4 {x, y, z, atom index};
// 4. extract: one block per cell, its warps taking groups of kGroup of the
//    cell's centers in turn. Cell ids run with z fastest, so the 27 neighbor
//    cells are 9 runs of 3 consecutive cells (18 where z wraps), which the
//    warp walks as one flat index space, 32 candidates at a time, each tested
//    against its kGroup centers; a ballot gives each center's in-cutoff mask
//    and the popcount below the lane the slot, in which the lane stages the
//    neighbor's atom index (shared memory, kGroup x K ints per warp). Then,
//    center by center, each lane takes a staged neighbor, counts the staged
//    indices below its own (its slot in ascending order: a rank sort with no
//    barrier, where a bitonic sort would need log^2 of them), recomputes the
//    displacement from the index and writes the slot; the slots past the
//    count are cleared and the count written at the center's own row. The
//    padding cell's block writes its centers' empty rows, so every row is
//    written and the wrapper allocates the outputs without clearing them.
// Center stripe (stage 1 of sharded_adf_histogram_2d; the TPU kernel's
// centers= mode, pallas_adf.py:232): a launch may list only the centers c0 <=
// i < c0 + n_rows into (F, n_rows, K) outputs whose row i - c0 is row i of the
// full launch. Steps 1-3 still bin every atom (every atom is a candidate). In
// step 4 a warp takes a window of up to 32 slots of its cell's run, ballots
// which of them are stripe centers and tests those in groups of kGroup: a
// stripe's centers are scattered over the cells, so windows of kGroup slots
// would leave most groups nearly empty. A full launch takes windows of kGroup
// slots, the groups above. The padding cell writes the empty rows of the
// stripe's padding atoms only.
//
// The route needs three cells or more on every axis (so the 27 cells are
// distinct) and K <= kMaxK (the staging); ops/adf_kernel.py::
// extract_route decides.
//
// What bounds it on this card: the 10240-atom first-shell frame has ~7.7
// atoms a cell and ~208 candidates a center, so 2.1e6 distance tests, 4.7e7
// float32 operations: the 18 MB of K = 88 lists it writes set the bound
// (5.4 us at 3.35 TB/s), and four dependent launches and the per-cell warps'
// latency set the time. Tensor cores do not apply: the minimum image rounds
// each component.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_math.cuh"

namespace {

constexpr int kWarps = 4;             // warps per cell
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 4;             // centers a warp tests at once
constexpr int kMaxK = 512;            // widest staging per center
constexpr int kBinThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int64_t kMaxGridY = 65535;

struct Params {
  float bx, by, bz;
  float ibx, iby, ibz;
  float t;  // squared-distance threshold of the cutoff
  double lx, ly, lz;
  int n_atoms, n_species, k_n;
  int nx, ny, nz, n_cells;  // n_cells = nx * ny * nz; cell n_cells holds padding
  int c0, n_rows;           // the stripe of centers listed
  int window;               // run slots a warp takes at a time: kGroup, or 32 for a stripe
};

__device__ __forceinline__ int axis_cell(float x, double edge, int n) {
  double f = __ddiv_rn(static_cast<double>(x), edge);
  f = __dsub_rn(f, floor(f));
  const int c = static_cast<int>(floor(__dmul_rn(f, static_cast<double>(n))));
  return c < n - 1 ? c : n - 1;
}

// 1. cell and rank in the cell of every atom; count per cell
__global__ void bin_atoms(const float* __restrict__ pos, const int* __restrict__ sid,
                          int* __restrict__ cell_of, int* __restrict__ rank,
                          int* __restrict__ count, const Params p) {
  const int i = blockIdx.x * kBinThreads + threadIdx.x;
  if (i >= p.n_atoms) return;
  const int64_t f = blockIdx.y;
  const float* x = pos + (f * p.n_atoms + i) * 3;
  const int s = sid[i];
  int c = p.n_cells;
  if (s >= 0 && s < p.n_species) {
    c = (axis_cell(x[0], p.lx, p.nx) * p.ny + axis_cell(x[1], p.ly, p.ny)) * p.nz +
        axis_cell(x[2], p.lz, p.nz);
  }
  cell_of[f * p.n_atoms + i] = c;
  rank[f * p.n_atoms + i] = atomicAdd(&count[f * (p.n_cells + 1) + c], 1);
}

// 2. start[c] = count[0] + ... + count[c - 1], for c = 0 .. n_cells + 1
__global__ void __launch_bounds__(kScanThreads)
scan_counts(const int* __restrict__ count, int* __restrict__ start, const Params p) {
  __shared__ int partial[kScanThreads];
  const int n = p.n_cells + 1;
  const int* cnt = count + static_cast<int64_t>(blockIdx.x) * n;
  int* st = start + static_cast<int64_t>(blockIdx.x) * (n + 1);
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, n);
  int sum = 0;
  for (int c = lo; c < hi; ++c) sum += cnt[c];
  partial[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive Hillis-Steele
    const int v = threadIdx.x >= off ? partial[threadIdx.x - off] : 0;
    __syncthreads();
    partial[threadIdx.x] += v;
    __syncthreads();
  }
  int run = partial[threadIdx.x] - sum;
  for (int c = lo; c < hi; ++c) {
    st[c] = run;
    run += cnt[c];
  }
  if (threadIdx.x == kScanThreads - 1) st[n] = partial[kScanThreads - 1];
}

// 3. atoms in cell order
__global__ void scatter_atoms(const float* __restrict__ pos, const int* __restrict__ cell_of,
                             const int* __restrict__ rank, const int* __restrict__ start,
                             float4* __restrict__ sorted, const Params p) {
  const int i = blockIdx.x * kBinThreads + threadIdx.x;
  if (i >= p.n_atoms) return;
  const int64_t f = blockIdx.y;
  const int64_t a = f * p.n_atoms + i;
  const float* x = pos + a * 3;
  const int slot = start[f * (p.n_cells + 2) + cell_of[a]] + rank[a];
  sorted[f * p.n_atoms + slot] = make_float4(x[0], x[1], x[2], __int_as_float(i));
}

__device__ __forceinline__ int wrap(int c, int n) { return c < 0 ? c + n : (c >= n ? c - n : c); }

// 4. the lists: one block per cell; its warps take windows of the cell's run in
// turn, and the window's stripe centers in groups of kGroup. kIdx writes idx_out
// too: a template parameter, since a run-time test of the pointer in the write
// loops slowed the lean launches of several frames by ~17 % on an H100 (16 x
// 10240 atoms, first shell: 0.349 against 0.295 ms in chip_smoke.py's [2 extract])
template <bool kIdx>
__global__ void __launch_bounds__(kThreads)
cells_extract(const float* __restrict__ pos, const int* __restrict__ sid,
              const float4* __restrict__ sorted, const int* __restrict__ start,
              float* __restrict__ rx, float* __restrict__ ry, float* __restrict__ rz,
              float* __restrict__ dd, int* __restrict__ sid_out, int* __restrict__ counts,
              int* __restrict__ idx_out, const Params p) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cell = blockIdx.x;
  const unsigned int below = (1u << lane) - 1u;
  const int k = p.k_n;
  int* stage = smem + warp * kGroup * k;

  const int64_t f = blockIdx.y;
  const float4* frame_sorted = sorted + f * p.n_atoms;
  const float* frame = pos + f * p.n_atoms * 3;
  const int* st = start + f * (p.n_cells + 2);
  const int64_t frame_row = f * p.n_rows - p.c0;  // + i: center i's output row
  const int c_end = p.c0 + p.n_rows;
  const int width = p.window;
  const int run_lo = st[cell], run_hi = st[cell + 1];
  if (run_lo + warp * width >= run_hi) return;  // whole warps; no block barrier below

  if (cell == p.n_cells) {  // padding: empty rows
    for (int w0 = run_lo + warp * width; w0 < run_hi; w0 += kWarps * width) {
      for (int q = w0; q < min(w0 + width, run_hi); ++q) {
        const int i = __float_as_int(frame_sorted[q].w);
        if (i < p.c0 || i >= c_end) continue;  // warp-uniform
        const int64_t row = (frame_row + i) * k;
        for (int s = lane; s < k; s += 32) {
          rx[row + s] = 0.f;
          ry[row + s] = 0.f;
          rz[row + s] = 0.f;
          dd[row + s] = 0.f;
          sid_out[row + s] = -1;
          if constexpr (kIdx) idx_out[row + s] = -1;
        }
        if (lane == 0) counts[frame_row + i] = 0;
      }
    }
    return;
  }

  // the 27 neighbor cells as 18 runs of the cell-sorted atoms, two per (x, y)
  // neighbor: z - 1 .. z + 1, split in two where z wraps (the second empty
  // otherwise); run r covers flat candidate indices [pre[r], pre[r + 1])
  const int cz = cell % p.nz;
  const int cy = (cell / p.nz) % p.ny;
  const int cx = cell / (p.nz * p.ny);
  int lo[18], pre[19];
  pre[0] = 0;
#pragma unroll
  for (int o = 0; o < 9; ++o) {
    const int base = (wrap(cx + o / 3 - 1, p.nx) * p.ny + wrap(cy + o % 3 - 1, p.ny)) * p.nz;
    int a0, a1, b0, b1;
    if (cz == 0) {
      a0 = base, a1 = base + 2, b0 = base + p.nz - 1, b1 = base + p.nz;
    } else if (cz == p.nz - 1) {
      a0 = base + p.nz - 2, a1 = base + p.nz, b0 = base, b1 = base + 1;
    } else {
      a0 = base + cz - 1, a1 = base + cz + 2, b0 = base, b1 = base;
    }
    lo[2 * o] = st[a0];
    pre[2 * o + 1] = pre[2 * o] + st[a1] - st[a0];
    lo[2 * o + 1] = st[b0];
    pre[2 * o + 2] = pre[2 * o + 1] + st[b1] - st[b0];
  }
  const int n_cand = pre[18];

  for (int w0 = run_lo + warp * width; w0 < run_hi; w0 += kWarps * width) {
    const int wn = min(width, run_hi - w0);
    bool mine = false;
    if (lane < wn) {
      const int i = __float_as_int(frame_sorted[w0 + lane].w);
      mine = i >= p.c0 && i < c_end;
    }
    unsigned int pending = __ballot_sync(0xffffffffu, mine);  // the window's stripe centers
    while (pending != 0u) {  // warp-uniform
      const int first = __ffs(pending) - 1;
      int g = 0;
      float4 ctr[kGroup];
      int found[kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {  // the next kGroup of them, in run order
        int b = first;
        if (pending != 0u) {
          b = __ffs(pending) - 1;
          pending &= pending - 1u;
          ++g;
        }
        ctr[c] = frame_sorted[w0 + b];  // the same address in every lane
        found[c] = 0;
      }

      for (int f0 = 0; f0 < n_cand; f0 += 32) {
        const int fl = f0 + lane;
        int q = 0;
#pragma unroll
        for (int r = 0; r < 18; ++r) {
          if (fl >= pre[r]) q = lo[r] + (fl - pre[r]);
        }
        const bool live = fl < n_cand;
        const float4 a = frame_sorted[live ? q : w0];
        const int j = __float_as_int(a.w);
        const float tj = live ? p.t : -1.f;  // s >= 0 > -1: a dead lane is never in
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          const float dx = min_image(__fsub_rn(a.x, ctr[c].x), p.bx, p.ibx);
          const float dy = min_image(__fsub_rn(a.y, ctr[c].y), p.by, p.iby);
          const float dz = min_image(__fsub_rn(a.z, ctr[c].z), p.bz, p.ibz);
          const bool in = c < g && squared_norm(dx, dy, dz) <= tj && j != __float_as_int(ctr[c].w);
          const unsigned int mask = __ballot_sync(0xffffffffu, in);
          if (in) {
            const int slot = found[c] + __popc(mask & below);
            if (slot < k) stage[c * k + slot] = j;
          }
          found[c] += __popc(mask);
        }
      }
      __syncwarp();

#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        if (c >= g) break;  // warp-uniform
        const int i = __float_as_int(ctr[c].w);
        const int m = min(found[c], k);
        const int* buf = stage + c * k;
        const int64_t row = (frame_row + i) * k;
        // the neighbor in staged slot e goes to slot rank(e): the number of
        // staged indices below its own (indices are distinct)
        for (int e = lane; e < m; e += 32) {
          const int j = buf[e];
          const float xj = frame[3 * j], yj = frame[3 * j + 1], zj = frame[3 * j + 2];
          const int sj = sid[j];
          int rank = 0;
          for (int u = 0; u < m; ++u) rank += buf[u] < j ? 1 : 0;
          const float ox = min_image(__fsub_rn(xj, ctr[c].x), p.bx, p.ibx);
          const float oy = min_image(__fsub_rn(yj, ctr[c].y), p.by, p.iby);
          const float oz = min_image(__fsub_rn(zj, ctr[c].z), p.bz, p.ibz);
          rx[row + rank] = ox;
          ry[row + rank] = oy;
          rz[row + rank] = oz;
          dd[row + rank] = __fsqrt_rn(squared_norm(ox, oy, oz));
          sid_out[row + rank] = sj;
          if constexpr (kIdx) idx_out[row + rank] = j;
        }
        for (int e = m + lane; e < k; e += 32) {
          rx[row + e] = 0.f;
          ry[row + e] = 0.f;
          rz[row + e] = 0.f;
          dd[row + e] = 0.f;
          sid_out[row + e] = -1;
          if constexpr (kIdx) idx_out[row + e] = -1;
        }
        if (lane == 0) counts[frame_row + i] = found[c];
      }
      __syncwarp();  // the staging is read before the next group
    }
  }
}

size_t extract_smem(int64_t k_n) {
  return static_cast<size_t>(kWarps) * kGroup * k_n * sizeof(int);
}

}  // namespace

extern "C" {

// Int32 scratch the binned route needs per frame: cell and rank of each atom,
// count and start of each cell.
int64_t adf_neighbor_cells_scratch_ints(int64_t n_atoms, int64_t n_cells) {
  return 2 * n_atoms + (n_cells + 1) + (n_cells + 2);
}

// Writes the neighbor lists of the centers c0 .. c0 + n_rows - 1 of positions
// (n_frames, n_atoms, 3) float32 with species ids (n_atoms,) int32 into rx, ry,
// rz, d, sid_out (n_frames, n_rows, k_n) and counts (n_frames, n_rows), and
// into idx (n_frames, n_rows, k_n) int32 unless it is null (c0 = 0, n_rows =
// n_atoms: every center), over nx x ny x nz cells of the box (three or
// more each); t is the squared-distance threshold of the cutoff.
// Scratch: `ints` of n_frames * adf_neighbor_cells_scratch_ints(...) int32 and
// `sorted` of n_frames * n_atoms float4. Runs on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError().
int adf_neighbor_cells_launch(const void* positions, const void* species_id,
                              void* rx, void* ry, void* rz, void* d, void* sid_out,
                              void* counts, void* idx, void* ints, void* sorted,
                              int64_t n_frames, int64_t n_atoms, int64_t n_species,
                              int64_t k_n, int64_t c0, int64_t n_rows, int64_t nx,
                              int64_t ny, int64_t nz, float bx, float by, float bz,
                              float ibx, float iby, float ibz, float t, void* stream) {
  if (k_n > kMaxK || nx < 3 || ny < 3 || nz < 3) return cudaErrorInvalidValue;
  if (c0 < 0 || n_rows < 0 || c0 + n_rows > n_atoms) return cudaErrorInvalidValue;
  if (n_rows == 0 || n_frames == 0) return cudaSuccess;
  const int n_cells = static_cast<int>(nx * ny * nz);
  const bool stripe = c0 != 0 || n_rows != n_atoms;
  const Params p{bx, by, bz, ibx, iby, ibz, t,
                 static_cast<double>(bx), static_cast<double>(by), static_cast<double>(bz),
                 static_cast<int>(n_atoms), static_cast<int>(n_species),
                 static_cast<int>(k_n),
                 static_cast<int>(nx), static_cast<int>(ny), static_cast<int>(nz), n_cells,
                 static_cast<int>(c0), static_cast<int>(n_rows), stripe ? 32 : kGroup};
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = extract_smem(k_n);
  const auto extract = idx == nullptr ? cells_extract<false> : cells_extract<true>;
  cudaError_t err = cudaFuncSetAttribute(extract, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t per_frame = adf_neighbor_cells_scratch_ints(n_atoms, n_cells);
  const unsigned int atom_blocks =
      static_cast<unsigned int>((n_atoms + kBinThreads - 1) / kBinThreads);
  const unsigned int cell_blocks = static_cast<unsigned int>(n_cells + 1);
  const int64_t list = n_rows * k_n;
  for (int64_t f0 = 0; f0 < n_frames; f0 += kMaxGridY) {
    const int64_t nf = n_frames - f0 < kMaxGridY ? n_frames - f0 : kMaxGridY;
    int* base = static_cast<int*>(ints) + f0 * per_frame;
    int* cell_of = base;
    int* rank = cell_of + nf * n_atoms;
    int* count = rank + nf * n_atoms;
    int* start = count + nf * (n_cells + 1);
    const float* pos = static_cast<const float*>(positions) + f0 * n_atoms * 3;
    float4* srt = static_cast<float4*>(sorted) + f0 * n_atoms;
    const int* sid = static_cast<const int*>(species_id);
    err = cudaMemsetAsync(count, 0, nf * (n_cells + 1) * sizeof(int), s);
    if (err != cudaSuccess) return err;
    const dim3 atom_grid(atom_blocks, static_cast<unsigned int>(nf));
    bin_atoms<<<atom_grid, kBinThreads, 0, s>>>(pos, sid, cell_of, rank, count, p);
    scan_counts<<<static_cast<unsigned int>(nf), kScanThreads, 0, s>>>(count, start, p);
    scatter_atoms<<<atom_grid, kBinThreads, 0, s>>>(pos, cell_of, rank, start, srt, p);
    extract<<<dim3(cell_blocks, static_cast<unsigned int>(nf)), kThreads, smem, s>>>(
        pos, sid, srt, start,
        static_cast<float*>(rx) + f0 * list, static_cast<float*>(ry) + f0 * list,
        static_cast<float*>(rz) + f0 * list, static_cast<float*>(d) + f0 * list,
        static_cast<int*>(sid_out) + f0 * list,
        static_cast<int*>(counts) + f0 * n_rows,
        idx == nullptr ? nullptr : static_cast<int*>(idx) + f0 * list, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
