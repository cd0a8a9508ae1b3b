// Per-center neighbor lists inside a cutoff (the ADF's first stage), for Hopper:
// the sweep route of the neighbor extract, in every mode.
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
//   neighbors of kArcCenters consecutive centers lie in a few runs of the
//   sorted order. arcs (F * n_arc_blocks, 2 * n_arcs) int32 give each such
//   group up to n_arcs circular (start, count) arcs in chunks of kChunk
//   atoms; its blocks test only the atoms of its arcs. A circular arc wraps
//   at the end of the order (the periodic seam: a center near z = 0 sees
//   atoms near z = L_z through it); a block cuts its arcs into linear ranges
//   and sweeps them in ascending order, so slots stay in ascending sorted j
//   and the lists equal the sweep's over the whole sorted frame
//   (ops/sorting.py builds arcs that cover every chunk holding a neighbor of
//   the group). A group whose arcs cover more than bound_chunks chunks sets
//   *overflow to 1: the caller's bound on the window
//   (ops/sorting.py::window_chunk_bound) was wrong for this frame. The block
//   still sweeps its whole window, so the lists stay exact; the flag tells
//   the caller that the frame is far from the density the route was chosen
//   for (parallel/sharded_ops.py repeats such a batch on the plain sweep, as
//   the JAX package does after its clamped windows).
//
// Why kChunk = 32 and kArcCenters = 32: the TPU kernel's chunks were 128-lane
// vector registers with VMEM scratch per window chunk. Here a warp tests 32
// consecutive j atoms per step (one lane each), so a 32-atom chunk is the
// unit the inner loop already walks: a window costs no partial steps, and the
// arcs are four times finer than 128-atom chunks, which narrows the window at
// the same sort. One arc list serves 32 centers: two blocks of 16.
//
// What bounds each mode on this card (inferred from the SASS and from timed
// variants on an H100, chip_sweep_variants.py). The full sweeps (every
// center against every atom: the plain, stripe, idx and open modes) are
// bound by instruction issue: a step, 32 atoms against a warp's 4 centers,
// issues the 80 rounded operations of its tests (20 a test: 3 differences,
// 3 minimum images of 4, 5 for s; no FMA under -fmad=false) and its loads,
// vote and loop besides, for N^2 tests a frame (1.05e8 at 10240 atoms),
// where the function needs only a 27-cell neighborhood's. The window modes
// at wide lists (K = 1024 at 32768 atoms, ~520 neighbors a center, 5-10 % of
// the window's atoms kept) are bound the same way, with a ballot and its
// staging for nearly every center at nearly every step on top of the tests;
// their list writes (20 bytes a slot, 24 with idx, every slot of every row:
// 1.3 GB for two frames, 0.4 ms) no longer set the pace. Tensor cores do not
// apply: the minimum image rounds each component.
//
// Design.
// * One block of 4 warps takes 16 centers of one frame, 4 a warp in
//   registers; a lane tests one j atom a step against its warp's 4 centers.
//   8 centers a warp would read each atom for twice the tests, but need 128
//   registers, and the fewer warps an SM then holds run slower
//   (chip_sweep_variants.py). 16-center blocks give a one-frame launch at
//   10240 atoms 640 blocks, about 5 on each of the 132 SMs in one wave.
// * One vote a step: a center or an atom outside [0, S) (or past the tile)
//   gets NaN coordinates, whose s fails the s <= t test, so a test is its
//   arithmetic and the compare; the warp takes one __any_sync of its lanes'
//   4 results and goes on to the per-center ballots only when some lane
//   kept a pair. The self pair leaves its center's ballot by lane, in the one
//   or two steps that hold the warp's own indices.
// * Staged whole-line writes. A kept pair's rx, ry, rz, sid (and j) go to its
//   center's ring of kRing = 64 slots a field in shared memory, at its slot in
//   ascending j (the ballot's prefix count). When a center's slots complete a
//   128-byte line of the output (slot boundaries aligned to the global
//   element index, so every line but a row's first and last is whole when
//   each output starts on a 128-byte boundary, as the wrapper allocates
//   them), the warp writes that line, one field an instruction, with d =
//   sqrt(s) from the staged components (the same rounded operations). After
//   the sweep one coalesced pass a center writes the staged remainder and
//   the empty slots up to K, and the count. Every list byte is written once;
//   slots above K are never staged; the counts stay true.
// * Overlapped tile loads. j atoms come in tiles of kJTile = 512: positions
//   as packed floats (x, y, z at stride 3, read without bank conflicts) and
//   ids, copied with cp.async (16-byte copies where the frame's rows are
//   16-byte aligned, else 4-byte ones) into kStages = 2 buffers: the next
//   tile loads while the warps test this one. More buffers and smaller tiles
//   measured slower (chip_sweep_variants.py); larger ones would pass the 48
//   KB a block gets without opting in.
// The wrapper allocates the outputs without clearing them.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "pair_math.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCentersPerWarp = 4;
constexpr int kCentersPerBlock = kWarps * kCentersPerWarp;
constexpr int kArcCenters = 32;  // centers one arc list serves (ops/sorting.py BLOCK_CENTERS)
constexpr int kBlocksPerArc = kArcCenters / kCentersPerBlock;
constexpr int kJTile = 512;  // j atoms of one tile
constexpr int kStages = 2;   // tiles in flight
constexpr int kChunk = 32;   // atoms of one window chunk
constexpr int kMaxArcs = 16; // arcs an arc list may hold
constexpr int kRing = 64;    // staged slots a center and field
constexpr int kLine = 32;    // slots of one 128-byte line
constexpr int kNever = INT_MAX;
constexpr int kField = kCentersPerBlock * kRing;  // floats of one field's rings
constexpr int64_t kMaxGridY = 65535;
static_assert(kArcCenters % kCentersPerBlock == 0, "an arc list serves whole blocks");

// Dynamic shared memory of a block: the tile buffers, then the rings of the
// 4 staged fields rx, ry, rz, sid (5 with idx).
constexpr int shared_bytes(bool idx) {
  return kStages * kJTile * 4 * (3 + 1) + (idx ? 5 : 4) * kField * 4;
}
// with the kernel's ranges, within the 48 KB a block gets without opting in
static_assert(shared_bytes(true) + 2 * kMaxArcs * 8 + 4 <= 48 * 1024, "shared memory");

struct Params {
  float bx, by, bz;
  float ibx, iby, ibz;
  float t;  // squared-distance threshold of the cutoff
  int n_atoms, n_species, k_n;
  int c0, n_rows;        // the stripe of centers listed
  int64_t sid_stride;    // 0: one species row for every frame; n_atoms: a row a frame
  int n_arcs;            // 0: every atom; else arcs of the window per arc list
  int n_arc_blocks;      // arc lists of one frame
  int64_t bound_chunks;  // a window above this sets *overflow
  int vec;               // rows of the positions and ids start 16-byte aligned
};

// Keeps a value in a register from here on: the compiler may not recompute it
// from its sources (it would rebuild the lane, the centers and the tile
// addresses from special registers on every step).
__device__ __forceinline__ int pin(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

template <bool kPeriodic>
__device__ __forceinline__ float displacement(float xj, float xi, float b, float ib) {
  const float dx = __fsub_rn(xj, xi);
  return kPeriodic ? min_image(dx, b, ib) : dx;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Starts the copy of atoms j0 .. j0 + len - 1 into one tile buffer (the
// caller commits the group).
__device__ __forceinline__ void load_tile(float* tpos, int* tsid, const float* frame,
                                          const int* fsid, int j0, int len, bool vec) {
  if (vec) {  // j0 and len are multiples of 4
    for (int q = threadIdx.x; q < 3 * len / 4; q += kThreads)
      cp_async16(tpos + 4 * q, frame + 3 * j0 + 4 * q);
    for (int q = threadIdx.x; q < len / 4; q += kThreads) cp_async16(tsid + 4 * q, fsid + j0 + 4 * q);
  } else {
    for (int q = threadIdx.x; q < 3 * len; q += kThreads) cp_async4(tpos + q, frame + 3 * j0 + q);
    for (int q = threadIdx.x; q < len; q += kThreads) cp_async4(tsid + q, fsid + j0 + q);
  }
}

// The slot after the line that holds slot `from` of a row starting at
// element `row`: the next flush point, or kNever past K.
__device__ __forceinline__ int line_end(int64_t row, int from, int k_n) {
  const int end = from + kLine - static_cast<int>((row + from) & (kLine - 1));
  return end <= k_n ? end : kNever;
}

template <bool kIdx>
struct Lists {
  float *rx, *ry, *rz, *dd;
  int *sid, *idx;

  // Slot `slot` of row `row` from its center's ring (`ring` at the center).
  __device__ __forceinline__ void store(const float* ring, int64_t row, int slot) const {
    const int q = slot & (kRing - 1);
    const int64_t o = row + slot;
    const float x = ring[q], y = ring[kField + q], z = ring[2 * kField + q];
    rx[o] = x;
    ry[o] = y;
    rz[o] = z;
    dd[o] = __fsqrt_rn(squared_norm(x, y, z));  // s again, as the test took it
    sid[o] = __float_as_int(ring[3 * kField + q]);
    if (kIdx) idx[o] = __float_as_int(ring[4 * kField + q]);
  }

  __device__ __forceinline__ void empty(int64_t row, int slot) const {
    const int64_t o = row + slot;
    rx[o] = 0.f;
    ry[o] = 0.f;
    rz[o] = 0.f;
    dd[o] = 0.f;
    sid[o] = -1;
    if (kIdx) idx[o] = -1;
  }
};

template <bool kPeriodic, bool kIdx>
__global__ void __launch_bounds__(kThreads)
neighbor_extract_kernel(const float* __restrict__ pos, const int* __restrict__ sid,
                        const Lists<kIdx> out, int* __restrict__ counts,
                        const int* __restrict__ arcs, int* __restrict__ overflow,
                        const Params p) {
  extern __shared__ float4 shared[];
  float* tile_pos = reinterpret_cast<float*>(shared);                      // [kStages][3 * kJTile]
  int* tile_sid = reinterpret_cast<int*>(tile_pos + kStages * 3 * kJTile);  // [kStages][kJTile]
  float* rings = reinterpret_cast<float*>(tile_sid + kStages * kJTile);  // [field][center][kRing]
  __shared__ int2 ranges[2 * kMaxArcs];
  __shared__ int n_ranges;

  const int n = p.n_atoms;
  const int lane = pin(static_cast<int>(threadIdx.x & 31));
  const int warp = threadIdx.x >> 5;
  const unsigned int below = static_cast<unsigned int>(pin(static_cast<int>((1u << lane) - 1u)));
  const float nan = __int_as_float(0x7fc00000);
  const float* frame = pos + static_cast<int64_t>(blockIdx.y) * n * 3;
  const int* fsid = sid + static_cast<int64_t>(blockIdx.y) * p.sid_stride;
  const int64_t frame_row = static_cast<int64_t>(blockIdx.y) * p.n_rows - p.c0;

  // the j ranges of this block, ascending and disjoint
  if (threadIdx.x == 0) {
    int m = 0;
    if (p.n_arcs == 0) {
      ranges[m++] = make_int2(0, n);
    } else {
      const int* a = arcs + (static_cast<int64_t>(blockIdx.y) * p.n_arc_blocks +
                             blockIdx.x / kBlocksPerArc) * 2 * p.n_arcs;
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

  // this warp's centers i0 .. i0 + kCentersPerWarp - 1; one that lists
  // nothing (past the stripe, or an id outside [0, S)) gets NaN coordinates,
  // so it keeps no pair
  const int i0 = pin(p.c0 + static_cast<int>(blockIdx.x) * kCentersPerBlock + warp * kCentersPerWarp);
  float cx[kCentersPerWarp], cy[kCentersPerWarp], cz[kCentersPerWarp];
  int found[kCentersPerWarp], flushed[kCentersPerWarp], next[kCentersPerWarp];
#pragma unroll
  for (int c = 0; c < kCentersPerWarp; ++c) {
    const int i = i0 + c;
    const bool in = i < p.c0 + p.n_rows;
    const int s = in ? fsid[i] : -1;
    const bool live = in && static_cast<unsigned int>(s) < static_cast<unsigned int>(p.n_species);
    cx[c] = live ? frame[3 * i] : nan;
    cy[c] = live ? frame[3 * i + 1] : nan;
    cz[c] = live ? frame[3 * i + 2] : nan;
    found[c] = 0;
    flushed[c] = 0;
    next[c] = line_end((frame_row + i) * p.k_n, 0, p.k_n);
  }
  float* ring = rings + (warp * kCentersPerWarp) * kRing;  // center c's: ring + c * kRing
  __syncthreads();  // the ranges are set
  const int m_ranges = n_ranges;

  // tiles go through kStages buffers in turn, loads kStages - 1 tiles ahead
  int r_load = 0, j_load = m_ranges > 0 ? ranges[0].x : 0;
  const auto load_next = [&](int buffer) {
    if (r_load < m_ranges) {
      load_tile(tile_pos + buffer * 3 * kJTile, tile_sid + buffer * kJTile, frame, fsid, j_load,
                min(kJTile, ranges[r_load].y - j_load), p.vec);
      j_load += kJTile;
      if (j_load >= ranges[r_load].y) {
        ++r_load;
        j_load = r_load < m_ranges ? ranges[r_load].x : 0;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);  // empty past the last tile: the count holds
  };
#pragma unroll
  for (int b = 0; b < kStages - 1; ++b) load_next(b);
  int r = 0, j0 = m_ranges > 0 ? ranges[0].x : 0, buf = 0;
  while (r < m_ranges) {
    const int len = min(kJTile, ranges[r].y - j0);
    load_next(buf == 0 ? kStages - 1 : buf - 1);  // the buffer the last tile left
    cp_async_wait<kStages - 1>();
    __syncthreads();  // this tile is in

    const float* tpos = tile_pos + pin(buf * 3 * kJTile + 3 * lane);  // this lane's atoms
    const int* tsid = tile_sid + pin(buf * kJTile + lane);
    for (int t0 = 0; t0 < len; t0 += 32) {
      const int t = t0 + lane;
      const int sj = tsid[t0];
      const float xj = t < len && static_cast<unsigned int>(sj) < static_cast<unsigned int>(p.n_species)
                           ? tpos[3 * t0] : nan;
      const float yj = tpos[3 * t0 + 1], zj = tpos[3 * t0 + 2];
      const int jstep = j0 + t0;  // the step's first atom
      float dx[kCentersPerWarp], dy[kCentersPerWarp], dz[kCentersPerWarp];
      bool in[kCentersPerWarp];  // s <= t, the self pair included
      bool any = false;
#pragma unroll
      for (int c = 0; c < kCentersPerWarp; ++c) {
        dx[c] = displacement<kPeriodic>(xj, cx[c], p.bx, p.ibx);
        dy[c] = displacement<kPeriodic>(yj, cy[c], p.by, p.iby);
        dz[c] = displacement<kPeriodic>(zj, cz[c], p.bz, p.ibz);
        in[c] = squared_norm(dx[c], dy[c], dz[c]) <= p.t;
        any |= in[c];
      }
      if (!__any_sync(0xffffffffu, any)) continue;

      // the kept pairs of each center: the ballots first (their latencies
      // overlap), then the slots by prefix count, staged; center c's own lane
      // in this step, if any, is i0 + c - jstep
      const int self0 = i0 - jstep;
      const auto keep = [&](auto has_self) {
        unsigned int masks[kCentersPerWarp];
#pragma unroll
        for (int c = 0; c < kCentersPerWarp; ++c) {
          masks[c] = __ballot_sync(0xffffffffu, in[c]);
          if (decltype(has_self)::value) {
            const unsigned int self = static_cast<unsigned int>(self0 + c);
            masks[c] &= self < 32u ? ~(1u << self) : ~0u;
          }
        }
#pragma unroll
        for (int c = 0; c < kCentersPerWarp; ++c) {
          const unsigned int mask = masks[c];
          if (mask == 0u) continue;
          const int base = found[c];
          found[c] = base + __popc(mask);
          const int slot = base + __popc(mask & below);
          if ((mask >> lane) & 1u && slot < p.k_n) {
            float* rc = ring + c * kRing + (slot & (kRing - 1));
            rc[0] = dx[c];
            rc[kField] = dy[c];
            rc[2 * kField] = dz[c];
            rc[3 * kField] = __int_as_float(sj);
            if (kIdx) rc[4 * kField] = __int_as_float(jstep + lane);
          }
          if (found[c] >= next[c]) {  // a line of this center's slots is staged
            const int64_t row = (frame_row + i0 + c) * p.k_n;
            const int line_slot = next[c] - kLine + lane;
            __syncwarp();
            if (line_slot >= flushed[c]) out.store(ring + c * kRing, row, line_slot);
            __syncwarp();
            flushed[c] = next[c];
            next[c] = line_end(row, next[c], p.k_n);
          }
        }
      };
      if (static_cast<unsigned int>(self0 + kCentersPerWarp - 1) < 32u + kCentersPerWarp - 1) {
        keep(std::true_type{});
      } else {
        keep(std::false_type{});
      }
    }
    __syncthreads();  // this tile is consumed
    j0 += kJTile;
    if (j0 >= ranges[r].y) {
      ++r;
      j0 = r < m_ranges ? ranges[r].x : 0;
    }
    buf = buf == kStages - 1 ? 0 : buf + 1;
  }

  // the staged remainder, the empty slots up to K and the count, a line at a time
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kCentersPerWarp; ++c) {
    if (i0 + c >= p.c0 + p.n_rows) continue;
    const int64_t row = (frame_row + i0 + c) * p.k_n;
    const int staged = min(found[c], p.k_n);
    const int first = flushed[c] - static_cast<int>((row + flushed[c]) & (kLine - 1));
    for (int slot = first + lane; slot < p.k_n; slot += 32) {
      if (slot < flushed[c]) continue;
      if (slot < staged) {
        out.store(ring + c * kRing, row, slot);
      } else {
        out.empty(row, slot);
      }
    }
    if (lane == 0) counts[frame_row + i0 + c] = found[c];
  }
}

template <bool kPeriodic, bool kIdx>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* pos, const int* sid,
                   const Lists<kIdx>& out, int* counts, const int* arcs, int* overflow,
                   const Params& p) {
  neighbor_extract_kernel<kPeriodic, kIdx><<<grid, kThreads, shared_bytes(kIdx), stream>>>(
      pos, sid, out, counts, arcs, overflow, p);
  return cudaGetLastError();
}

template <bool kIdx>
cudaError_t launch_mode(bool periodic, dim3 grid, cudaStream_t stream, const float* pos,
                        const int* sid, const Lists<kIdx>& out, int* counts, const int* arcs,
                        int* overflow, const Params& p) {
  return periodic ? launch<true, kIdx>(grid, stream, pos, sid, out, counts, arcs, overflow, p)
                  : launch<false, kIdx>(grid, stream, pos, sid, out, counts, arcs, overflow, p);
}

}  // namespace

extern "C" {

// Centers one arc list of the window mode serves (the rows of the arcs) and
// atoms of one window chunk.
int adf_neighbor_extract_arc_centers() { return kArcCenters; }
int adf_neighbor_extract_chunk_atoms() { return kChunk; }

// Writes the neighbor lists of the centers c0 .. c0 + n_rows - 1 of positions
// (n_frames, n_atoms, 3) float32 with species ids (n_atoms,) int32 (sid_stride
// 0) or (n_frames, n_atoms) (sid_stride n_atoms) into rx, ry, rz, d (n_frames,
// n_rows, k_n) float32, sid_out (n_frames, n_rows, k_n) int32 and counts
// (n_frames, n_rows) int32, and into idx (n_frames, n_rows, k_n) int32 unless
// it is null, on `stream` (c0 = 0, n_rows = n_atoms: every center); t is the
// squared-distance threshold of the cutoff; periodic 0 leaves out the minimum
// image. n_arcs > 0 (every center, no stripe): arcs (n_frames * groups,
// 2 * n_arcs) int32 per group of adf_neighbor_extract_arc_centers()
// centers, in chunks of adf_neighbor_extract_chunk_atoms() atoms; *overflow
// (int32, cleared by the caller) is set to 1 where a group's arcs cover more
// than bound_chunks chunks. The lists are written in whole 128-byte lines
// where each output starts on a 128-byte boundary (any 4-byte alignment is
// right). Allocates nothing and does not synchronise; returns
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
  const int arc_blocks = static_cast<int>((n_rows + kArcCenters - 1) / kArcCenters);
  const bool vec = n_atoms % 4 == 0 && reinterpret_cast<uintptr_t>(positions) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(species_id) % 16 == 0;
  const Params p{bx, by, bz, ibx, iby, ibz, t,
                 static_cast<int>(n_atoms), static_cast<int>(n_species),
                 static_cast<int>(k_n), static_cast<int>(c0), static_cast<int>(n_rows),
                 sid_stride, static_cast<int>(n_arcs), arc_blocks, bound_chunks, vec};
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
    const int* farcs =
        arcs == nullptr ? nullptr : static_cast<const int*>(arcs) + f0 * arc_blocks * 2 * n_arcs;
    auto* ovf = static_cast<int*>(overflow);
    const cudaError_t err =
        idx == nullptr
            ? launch_mode<false>(periodic != 0, grid, s, fpos, fsid,
                                 Lists<false>{frx, fry, frz, fd, fso, nullptr}, fcnt, farcs, ovf, p)
            : launch_mode<true>(periodic != 0, grid, s, fpos, fsid,
                                Lists<true>{frx, fry, frz, fd, fso, static_cast<int*>(idx) + f0 * list},
                                fcnt, farcs, ovf, p);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
