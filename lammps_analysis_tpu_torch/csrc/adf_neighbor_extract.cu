// Per-center neighbor lists inside a cutoff (the ADF's first stage), for Hopper.
//
// Replaces the TPU kernel lammps_analysis_tpu/ops/pallas_adf.py::
// _neighbor_extract_pallas (:221) in all its modes but the TPU's tile shapes:
// for every frame and every center i whose species id lies in [0, S), every
// atom j != i with a species id in [0, S) and distance d < cutoff goes to the
// next of the center's K slots. Outputs are structure-of-arrays (F, N, K): rx,
// ry, rz, d (float32, r = pos_j - pos_i) and sid (int32); empty slots hold 0
// and sid -1. counts (F, N) int32 holds the TRUE in-cutoff count, which may
// exceed K: the caller retries with a larger K (no silent truncation).
//
// Slots come in ascending j, so the output is deterministic, and the plain
// torch version in ops/adf.py (neighbor_extract_reference: a cumulative sum
// of the in-cutoff mask, then a scatter) gives the same lists bit for bit.
// The arithmetic is K1's (csrc/rdf_histogram.cu, csrc/pair_math.cuh), each
// step an explicitly rounded intrinsic, built with -fmad=false:
//   dx = xj - xi;  dx = dx - bx * rint(dx * ibx)      (ibx = 1/bx in float32)
//   s  = dx*dx + dy*dy + dz*dz                          (left to right)
//   kept when s <= t, t the squared-distance threshold of the cutoff
//   (ops/geometry.py::squared_cutoff: exactly the pairs with sqrt(s) < cutoff);
//   d  = sqrt(s), for kept pairs only
//
// Modes (flags of the one launch function):
// * open boundaries (periodic = 0; the TPU kernel's box=None, :380): no
//   minimum image, dx = xj - xi; the same cutoff test;
// * the idx output (idx != null; the TPU kernel's lean=False, reached through
//   neighbor_indices_pallas :1395): int32 (F, rows, K) neighbor atom indices
//   in the same ascending-j slots, -1 in empty slots;
// * per-frame species (sid_stride = n_atoms): ids (F, N), for frames whose
//   atoms were reordered per frame (the sorted route below);
// * the center stripe (stage 1 of sharded_adf_histogram_2d; the TPU kernel's
//   centers= mode, :232): a launch may list only the centers c0 <= i < c0 +
//   n_rows, still against every atom, into (F, n_rows, K) outputs whose row
//   i - c0 is row i of the full launch; the self pair is left out by global
//   index. The grid covers the stripe's centers only;
// * the window (n_arcs > 0; the TPU kernel's window=, behind
//   sorted_neighbor_extract :1214). The caller has sorted each frame's atoms
//   in space (ops/sorting.py: by z, or by (z-slab, serpentine y)), so the
//   neighbors of a block's kCentersPerBlock consecutive centers lie in a few
//   runs of the sorted order. arcs (F * n_blocks, 2 * n_arcs) int32 give each
//   block up to n_arcs circular (start, count) arcs in chunks of kChunk atoms;
//   the block tests only the atoms of its arcs. A circular arc wraps at the
//   end of the order (the periodic seam: a center near z = 0 sees atoms near
//   z = L_z through it); the block cuts its arcs into linear ranges and sweeps
//   them in ascending order, so slots stay in ascending sorted j and the lists
//   equal the sweep's over the whole sorted frame (ops/sorting.py builds arcs
//   that cover every chunk holding a neighbor of the block). A block whose
//   arcs cover more than bound_chunks chunks sets *overflow to 1: the caller's
//   bound on the window (ops/sorting.py::window_chunk_bound) was wrong for
//   this frame. The block still sweeps its whole window, so the lists stay
//   exact; the flag tells the caller that the frame is far from the density
//   the route was chosen for (parallel/sharded_ops.py repeats such a batch on
//   the plain sweep, as the JAX package does after its clamped windows).
//
// Why kChunk = 32 and kCentersPerBlock = 32: the TPU kernel's chunks were
// 128-lane vector registers with VMEM scratch per window chunk. Here a warp
// tests 32 consecutive j atoms per step (one lane each), so a 32-atom chunk is
// the unit the inner loop already walks: a window costs no partial steps, and
// the arcs are four times finer than 128-atom chunks, which narrows the
// window at the same sort. A block's 32 centers (8 warps x 4) are the unit
// one arc list serves: they share the staged tiles of the window.
//
// Design. The TPU kernel compacted lanes with one-hot slot writes over
// 128-lane chunks; here a warp does it with a ballot. One block of 8 warps
// takes 32 centers (4 per warp, in registers) of one frame. The block stages
// j-tiles of kJTile atoms of each range in shared memory as float4 (x, y, z,
// species bits). Each lane loads one j per step and tests it against its
// warp's 4 centers: __ballot_sync gives the in-cutoff mask, __popc of the
// mask below the lane gives the slot, and lanes whose slot is below K write.
// Offsets into the outputs are 64-bit. After the sweep each warp fills its
// centers' empty slots and writes the counts, so the wrapper allocates the
// outputs without clearing them.
//
// What bounds it on this card: the distance tests, about 22 float32
// operations each (N^2 per frame on the plain sweep, 1.05e8 at 10240 atoms;
// the window's atoms per block on the sorted route); one shared-memory load
// feeds four tests. The writes (~20 bytes per neighbor, 24 with idx) are
// small beside that at first-shell widths and set the bound at wide lists
// (K = 1024 at 32768 atoms: 0.7 GB a frame). Tensor cores do not apply: the
// minimum image rounds each component.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_math.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCentersPerWarp = 4;
constexpr int kCentersPerBlock = kWarps * kCentersPerWarp;
constexpr int kJTile = 1024;  // j atoms staged per step (16 KB)
constexpr int kChunk = 32;    // atoms of one window chunk
constexpr int kMaxArcs = 16;  // arcs a block may take
constexpr int64_t kMaxGridY = 65535;

struct Params {
  float bx, by, bz;
  float ibx, iby, ibz;
  float t;  // squared-distance threshold of the cutoff
  int n_atoms, n_species, k_n;
  int c0, n_rows;        // the stripe of centers listed
  int64_t sid_stride;    // 0: one species row for every frame; n_atoms: a row a frame
  int n_arcs;            // 0: every atom; else arcs of the window per block
  int n_blocks;          // blocks a frame (rows of the arcs of one frame)
  int64_t bound_chunks;  // a window above this sets *overflow
};

template <bool kPeriodic>
__device__ __forceinline__ float displacement(float xj, float xi, float b, float ib) {
  const float dx = __fsub_rn(xj, xi);
  return kPeriodic ? min_image(dx, b, ib) : dx;
}

template <bool kPeriodic>
__global__ void __launch_bounds__(kThreads)
neighbor_extract_kernel(const float* __restrict__ pos, const int* __restrict__ sid,
                        float* __restrict__ rx, float* __restrict__ ry,
                        float* __restrict__ rz, float* __restrict__ dd,
                        int* __restrict__ sid_out, int* __restrict__ counts,
                        int* __restrict__ idx_out, const int* __restrict__ arcs,
                        int* __restrict__ overflow, const Params p) {
  __shared__ float4 tile[kJTile];
  __shared__ int2 ranges[2 * kMaxArcs];
  __shared__ int n_ranges;

  const int n = p.n_atoms;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned int below = (1u << lane) - 1u;
  const float* frame = pos + static_cast<int64_t>(blockIdx.y) * n * 3;
  const int* fsid = sid + static_cast<int64_t>(blockIdx.y) * p.sid_stride;
  const int64_t frame_row = static_cast<int64_t>(blockIdx.y) * p.n_rows - p.c0;

  // the j ranges of this block, ascending and disjoint
  if (threadIdx.x == 0) {
    int m = 0;
    if (p.n_arcs == 0) {
      ranges[m++] = make_int2(0, n);
    } else {
      const int* a = arcs + (static_cast<int64_t>(blockIdx.y) * p.n_blocks + blockIdx.x) * 2 * p.n_arcs;
      const int n_chunks = (n + kChunk - 1) / kChunk;
      int64_t covered = 0;
      for (int q = 0; q < p.n_arcs; ++q) {
        const int start = a[2 * q], count = min(a[2 * q + 1], n_chunks);
        covered += a[2 * q + 1];
        if (count <= 0) continue;
        const int end = start + count;  // in chunks; past n_chunks wraps
        ranges[m++] = make_int2(start * kChunk, min(end, n_chunks) * kChunk);
        if (end > n_chunks) ranges[m++] = make_int2(0, (end - n_chunks) * kChunk);
      }
      if (covered > p.bound_chunks) atomicExch(overflow, 1);
      for (int q = 1; q < m; ++q) {  // insertion sort by start
        const int2 v = ranges[q];
        int r = q - 1;
        while (r >= 0 && ranges[r].x > v.x) {
          ranges[r + 1] = ranges[r];
          --r;
        }
        ranges[r + 1] = v;
      }
      int w = 0;  // merge overlaps, clamp to the atoms
      for (int q = 0; q < m; ++q) {
        const int2 v = make_int2(ranges[q].x, min(ranges[q].y, n));
        if (v.x >= v.y) continue;
        if (w > 0 && v.x <= ranges[w - 1].y) {
          ranges[w - 1].y = max(ranges[w - 1].y, v.y);
        } else {
          ranges[w++] = v;
        }
      }
      m = w;
    }
    n_ranges = m;
  }

  float cx[kCentersPerWarp], cy[kCentersPerWarp], cz[kCentersPerWarp];
  int ci[kCentersPerWarp], found[kCentersPerWarp];
  bool live[kCentersPerWarp];
#pragma unroll
  for (int c = 0; c < kCentersPerWarp; ++c) {
    const int i = p.c0 + blockIdx.x * kCentersPerBlock + warp * kCentersPerWarp + c;
    const bool in = i < p.c0 + p.n_rows;
    const int s = in ? fsid[i] : -1;
    ci[c] = i;
    live[c] = in && s >= 0 && s < p.n_species;
    cx[c] = in ? frame[3 * i] : 0.f;
    cy[c] = in ? frame[3 * i + 1] : 0.f;
    cz[c] = in ? frame[3 * i + 2] : 0.f;
    found[c] = 0;
  }
  __syncthreads();  // the ranges are set
  const int m_ranges = n_ranges;

  for (int r = 0; r < m_ranges; ++r) {
    const int2 range = ranges[r];
    for (int j0 = range.x; j0 < range.y; j0 += kJTile) {
      __syncthreads();  // the previous tile is consumed
      const int t_end = min(kJTile, range.y - j0);
      for (int t = threadIdx.x; t < kJTile; t += kThreads) {
        const int j = j0 + t;
        float4 v = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
        if (t < t_end) {
          const int s = fsid[j];
          v = make_float4(frame[3 * j], frame[3 * j + 1], frame[3 * j + 2],
                          __int_as_float(s >= 0 && s < p.n_species ? s : -1));
        }
        tile[t] = v;
      }
      __syncthreads();

      for (int t0 = 0; t0 < t_end; t0 += 32) {
        const float4 a = tile[t0 + lane];  // past t_end: species -1, never in
        const int sj = __float_as_int(a.w);
        const int j = j0 + t0 + lane;
#pragma unroll
        for (int c = 0; c < kCentersPerWarp; ++c) {
          const float dx = displacement<kPeriodic>(a.x, cx[c], p.bx, p.ibx);
          const float dy = displacement<kPeriodic>(a.y, cy[c], p.by, p.iby);
          const float dz = displacement<kPeriodic>(a.z, cz[c], p.bz, p.ibz);
          const float s = squared_norm(dx, dy, dz);
          const bool in = live[c] && sj >= 0 && j != ci[c] && s <= p.t;
          const unsigned int mask = __ballot_sync(0xffffffffu, in);
          if (in) {
            const int slot = found[c] + __popc(mask & below);
            if (slot < p.k_n) {
              const int64_t o = (frame_row + ci[c]) * p.k_n + slot;
              rx[o] = dx;
              ry[o] = dy;
              rz[o] = dz;
              dd[o] = __fsqrt_rn(s);
              sid_out[o] = sj;
              if (idx_out != nullptr) idx_out[o] = j;
            }
          }
          found[c] += __popc(mask);
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kCentersPerWarp; ++c) {
    if (ci[c] >= p.c0 + p.n_rows) continue;
    const int64_t row = (frame_row + ci[c]) * p.k_n;
    for (int s = min(found[c], p.k_n) + lane; s < p.k_n; s += 32) {
      rx[row + s] = 0.f;
      ry[row + s] = 0.f;
      rz[row + s] = 0.f;
      dd[row + s] = 0.f;
      sid_out[row + s] = -1;
      if (idx_out != nullptr) idx_out[row + s] = -1;
    }
    if (lane == 0) counts[frame_row + ci[c]] = found[c];
  }
}

}  // namespace

extern "C" {

// Centers a block of the sweep takes (the rows of the window's arcs) and
// atoms of one window chunk.
int adf_neighbor_extract_block_centers() { return kCentersPerBlock; }
int adf_neighbor_extract_chunk_atoms() { return kChunk; }

// Writes the neighbor lists of the centers c0 .. c0 + n_rows - 1 of positions
// (n_frames, n_atoms, 3) float32 with species ids (n_atoms,) int32 (sid_stride
// 0) or (n_frames, n_atoms) (sid_stride n_atoms) into rx, ry, rz, d (n_frames,
// n_rows, k_n) float32, sid_out (n_frames, n_rows, k_n) int32 and counts
// (n_frames, n_rows) int32, and into idx (n_frames, n_rows, k_n) int32 unless
// it is null, on `stream` (c0 = 0, n_rows = n_atoms: every center); t is the
// squared-distance threshold of the cutoff; periodic 0 leaves out the minimum
// image. n_arcs > 0 (every center, no stripe): arcs (n_frames * blocks,
// 2 * n_arcs) int32 per block of adf_neighbor_extract_block_centers() centers,
// in chunks of adf_neighbor_extract_chunk_atoms() atoms; *overflow (int32,
// cleared by the caller) is set to 1 where a block's arcs cover more than
// bound_chunks chunks. Allocates nothing and does not synchronise; returns
// cudaGetLastError().
int adf_neighbor_extract_launch(const void* positions, const void* species_id,
                                void* rx, void* ry, void* rz, void* d,
                                void* sid_out, void* counts, void* idx, int64_t n_frames,
                                int64_t n_atoms, int64_t n_species, int64_t k_n,
                                int64_t c0, int64_t n_rows, int64_t sid_stride,
                                int64_t periodic, const void* arcs, int64_t n_arcs,
                                int64_t bound_chunks, void* overflow, float bx, float by,
                                float bz, float ibx, float iby, float ibz, float t,
                                void* stream) {
  if (c0 < 0 || n_rows < 0 || c0 + n_rows > n_atoms) return cudaErrorInvalidValue;
  if (sid_stride != 0 && sid_stride != n_atoms) return cudaErrorInvalidValue;
  if (n_arcs < 0 || n_arcs > kMaxArcs) return cudaErrorInvalidValue;
  if (n_arcs > 0 && (arcs == nullptr || overflow == nullptr || c0 != 0 || n_rows != n_atoms))
    return cudaErrorInvalidValue;
  if (n_rows == 0 || n_frames == 0) return cudaSuccess;
  const int blocks = static_cast<int>((n_rows + kCentersPerBlock - 1) / kCentersPerBlock);
  const Params p{bx, by, bz, ibx, iby, ibz, t,
                 static_cast<int>(n_atoms), static_cast<int>(n_species),
                 static_cast<int>(k_n), static_cast<int>(c0), static_cast<int>(n_rows),
                 sid_stride, static_cast<int>(n_arcs), blocks, bound_chunks};
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t list = n_rows * k_n;
  for (int64_t f0 = 0; f0 < n_frames; f0 += kMaxGridY) {
    const dim3 grid(static_cast<unsigned int>(blocks),
                    static_cast<unsigned int>(n_frames - f0 < kMaxGridY ? n_frames - f0
                                                                        : kMaxGridY));
    const float* fpos = static_cast<const float*>(positions) + f0 * n_atoms * 3;
    const int* fsid = static_cast<const int*>(species_id) + f0 * sid_stride;
    float* frx = static_cast<float*>(rx) + f0 * list;
    float* fry = static_cast<float*>(ry) + f0 * list;
    float* frz = static_cast<float*>(rz) + f0 * list;
    float* fd = static_cast<float*>(d) + f0 * list;
    int* fso = static_cast<int*>(sid_out) + f0 * list;
    int* fcnt = static_cast<int*>(counts) + f0 * n_rows;
    int* fidx = idx == nullptr ? nullptr : static_cast<int*>(idx) + f0 * list;
    const int* farcs =
        arcs == nullptr ? nullptr : static_cast<const int*>(arcs) + f0 * blocks * 2 * n_arcs;
    auto* ovf = static_cast<int*>(overflow);
    if (periodic) {
      neighbor_extract_kernel<true><<<grid, kThreads, 0, s>>>(
          fpos, fsid, frx, fry, frz, fd, fso, fcnt, fidx, farcs, ovf, p);
    } else {
      neighbor_extract_kernel<false><<<grid, kThreads, 0, s>>>(
          fpos, fsid, frx, fry, frz, fd, fso, fcnt, fidx, farcs, ovf, p);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
