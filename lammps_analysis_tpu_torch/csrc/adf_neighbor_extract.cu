// Per-center neighbor lists inside a cutoff (the ADF's first stage), for Hopper.
//
// Replaces the TPU kernel lammps_analysis_tpu/ops/pallas_adf.py::
// _neighbor_extract_pallas (:221, lean=True): for every frame and every center
// i whose species id lies in [0, S), every atom j != i with a species id in
// [0, S) and minimum-image distance d < cutoff goes to the next of the
// center's K slots. Outputs are structure-of-arrays (F, N, K): rx, ry, rz, d
// (float32, r = pos_j - pos_i) and sid (int32); empty slots hold 0 and sid -1.
// counts (F, N) int32 holds the TRUE in-cutoff count, which may exceed K: the
// caller retries with a larger K (no silent truncation).
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
// Center stripe (stage 1 of sharded_adf_histogram_2d; the TPU kernel's
// centers= mode, pallas_adf.py:232): a launch may list only the centers c0 <=
// i < c0 + n_rows, still against every atom, into (F, n_rows, K) outputs
// whose row i - c0 is row i of the full launch; the self pair is left out by
// global index. The grid covers the stripe's centers only.
//
// This is the sweep route, for boxes with fewer than three cells of the
// cutoff on some axis and for lists too wide for the binned route
// (csrc/adf_neighbor_cells.cu); ops/adf_kernel.py::extract_route decides.
//
// Design. The TPU kernel compacted lanes with one-hot slot writes over
// 128-lane chunks; here a warp does it with a ballot. One block of 8 warps
// takes 32 centers (4 per warp, in registers) of one frame. The block stages
// j-tiles of kJTile atoms in shared memory as float4 (x, y, z, species bits).
// Each lane loads one j per step and tests it against its warp's 4 centers:
// __ballot_sync gives the in-cutoff mask, __popc of the mask below the lane
// gives the slot, and lanes whose slot is below K write. Offsets into the
// outputs are 64-bit. After the sweep each warp fills its centers' empty
// slots and writes the counts, so the wrapper allocates the outputs without
// clearing them.
//
// What bounds it on this card: the N^2 distance tests per frame (1.05e8 at
// 10240 atoms), about 22 float32 operations each; one shared-memory load
// feeds four tests. The writes (~20 bytes per neighbor) are small beside
// that. Tensor cores do not apply: the minimum image rounds each component.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_math.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCentersPerWarp = 4;
constexpr int kCentersPerBlock = kWarps * kCentersPerWarp;
constexpr int kJTile = 1024;  // j atoms staged per step (16 KB)
constexpr int64_t kMaxGridY = 65535;

struct Params {
  float bx, by, bz;
  float ibx, iby, ibz;
  float t;  // squared-distance threshold of the cutoff
  int n_atoms, n_species, k_n;
  int c0, n_rows;  // the stripe of centers listed
};

__global__ void __launch_bounds__(kThreads)
neighbor_extract_kernel(const float* __restrict__ pos, const int* __restrict__ sid,
                        float* __restrict__ rx, float* __restrict__ ry,
                        float* __restrict__ rz, float* __restrict__ dd,
                        int* __restrict__ sid_out, int* __restrict__ counts,
                        const Params p) {
  __shared__ float4 tile[kJTile];

  const int n = p.n_atoms;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned int below = (1u << lane) - 1u;
  const float* frame = pos + static_cast<int64_t>(blockIdx.y) * n * 3;
  const int64_t frame_row = static_cast<int64_t>(blockIdx.y) * p.n_rows - p.c0;

  float cx[kCentersPerWarp], cy[kCentersPerWarp], cz[kCentersPerWarp];
  int ci[kCentersPerWarp], found[kCentersPerWarp];
  bool live[kCentersPerWarp];
#pragma unroll
  for (int c = 0; c < kCentersPerWarp; ++c) {
    const int i = p.c0 + blockIdx.x * kCentersPerBlock + warp * kCentersPerWarp + c;
    const bool in = i < p.c0 + p.n_rows;
    const int s = in ? sid[i] : -1;
    ci[c] = i;
    live[c] = in && s >= 0 && s < p.n_species;
    cx[c] = in ? frame[3 * i] : 0.f;
    cy[c] = in ? frame[3 * i + 1] : 0.f;
    cz[c] = in ? frame[3 * i + 2] : 0.f;
    found[c] = 0;
  }

  for (int j0 = 0; j0 < n; j0 += kJTile) {
    __syncthreads();  // the previous tile is consumed
    for (int t = threadIdx.x; t < kJTile; t += kThreads) {
      const int j = j0 + t;
      float4 v = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
      if (j < n) {
        const int s = sid[j];
        v = make_float4(frame[3 * j], frame[3 * j + 1], frame[3 * j + 2],
                        __int_as_float(s >= 0 && s < p.n_species ? s : -1));
      }
      tile[t] = v;
    }
    __syncthreads();

    const int t_end = min(kJTile, n - j0);
    for (int t0 = 0; t0 < t_end; t0 += 32) {
      const float4 a = tile[t0 + lane];  // past t_end: species -1, never in
      const int sj = __float_as_int(a.w);
      const int j = j0 + t0 + lane;
#pragma unroll
      for (int c = 0; c < kCentersPerWarp; ++c) {
        const float dx = min_image(__fsub_rn(a.x, cx[c]), p.bx, p.ibx);
        const float dy = min_image(__fsub_rn(a.y, cy[c]), p.by, p.iby);
        const float dz = min_image(__fsub_rn(a.z, cz[c]), p.bz, p.ibz);
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
          }
        }
        found[c] += __popc(mask);
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
    }
    if (lane == 0) counts[frame_row + ci[c]] = found[c];
  }
}

}  // namespace

extern "C" {

// Writes the neighbor lists of the centers c0 .. c0 + n_rows - 1 of positions
// (n_frames, n_atoms, 3) float32 with species ids (n_atoms,) int32 into rx, ry,
// rz, d (n_frames, n_rows, k_n) float32, sid_out (n_frames, n_rows, k_n) int32
// and counts (n_frames, n_rows) int32, on `stream` (c0 = 0, n_rows = n_atoms:
// every center); t is the squared-distance threshold of the cutoff. Allocates
// nothing and does not synchronise; returns cudaGetLastError().
int adf_neighbor_extract_launch(const void* positions, const void* species_id,
                                void* rx, void* ry, void* rz, void* d,
                                void* sid_out, void* counts, int64_t n_frames,
                                int64_t n_atoms, int64_t n_species, int64_t k_n,
                                int64_t c0, int64_t n_rows, float bx, float by,
                                float bz, float ibx, float iby, float ibz, float t,
                                void* stream) {
  if (c0 < 0 || n_rows < 0 || c0 + n_rows > n_atoms) return cudaErrorInvalidValue;
  if (n_rows == 0 || n_frames == 0) return cudaSuccess;
  const Params p{bx, by, bz, ibx, iby, ibz, t,
                 static_cast<int>(n_atoms), static_cast<int>(n_species),
                 static_cast<int>(k_n), static_cast<int>(c0), static_cast<int>(n_rows)};
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks =
      static_cast<unsigned int>((n_rows + kCentersPerBlock - 1) / kCentersPerBlock);
  const int64_t list = n_rows * k_n;
  for (int64_t f0 = 0; f0 < n_frames; f0 += kMaxGridY) {
    const dim3 grid(blocks, static_cast<unsigned int>(
                                n_frames - f0 < kMaxGridY ? n_frames - f0 : kMaxGridY));
    neighbor_extract_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(positions) + f0 * n_atoms * 3,
        static_cast<const int*>(species_id),
        static_cast<float*>(rx) + f0 * list, static_cast<float*>(ry) + f0 * list,
        static_cast<float*>(rz) + f0 * list, static_cast<float*>(d) + f0 * list,
        static_cast<int*>(sid_out) + f0 * list,
        static_cast<int*>(counts) + f0 * n_rows, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
