// Pack and power sum of the windowed FFT autocorrelation's batches, for Hopper.
//
// The windowed ACF (ops/correlation.py::windowed_acf_sum) correlates each
// window of every particle's component by a zero-padded real FFT: a batch of
// B windows of S = N*D sequences is packed into a (B, S, L) float32 buffer,
// cuFFT (torch.fft.rfft) turns it into a (B, S, F) complex64 spectrum, F =
// L/2 + 1, and the power |X|^2 is summed over the S sequences into one (F,)
// float64 row a window, which one inverse FFT a window turns into the ACF.
// These two kernels are the pack and the power sum around cuFFT. They
// replace no Pallas kernel: the JAX package runs these steps as XLA ops
// (jnp.fft in lammps_analysis_tpu/ops/correlation.py::windowed_acf_sum), and
// the port ran them as torch ops, whose pad, strided copy, square, float64
// cast and float64 reduction moved about three times the bytes these two
// kernels move.
//
// acf_pack_kernel: buf[b, s, k] = x[first + b * stride + lag_k, s] for k < R
// and 0 for R <= k < L, with lag_k = k, or lags[k] where a lag table is
// given; x is the (T, S) float32 slab. Bound by the bytes it writes,
// B*S*R*4 into a reused buffer and B*S*L*4 with the tail (the slab's reads
// come from L2: neighbouring windows share all but `stride` of their
// frames). Design: 32 x 32 tiles transposed through shared memory, read
// along s (coalesced runs of the slab's rows) and written along k (128-byte
// runs of the buffer's rows); a block packs kRun consecutive k tiles of one
// column tile, the next tile's loads issued before the current tile's
// stores (with one load, sync and store round a block, the blocks' turnover
// held the kernel at 47 % of its bound); the blocks of one column tile and
// k run of consecutive windows are consecutive in the grid, so the frames
// they share come from DRAM once and from L2 after. Where S < 32 a
// tile's 32 columns hold floor(32 / S) windows side by side, so a system
// series (S = 3) does not leave 29 of 32 threads idle. The zero tail
// k >= R is written only where the caller asks (`tail`): the wrapper
// allocates the buffer once a call and the later batches reuse it, cuFFT's
// out-of-place R2C leaving its input as it was.
//
// acf_power_sum_kernel: power[b, f] = sum over s of double(re*re) +
// double(im*im), each square rounded in float32 as torch's square_ rounds it
// and the sum taken in float64, as the torch ops took it; only the order of
// the float64 adds differs. Bound by the bytes it reads, the spectrum's
// B*S*F*8, once. Design: threads run along f, a row of F complex values
// being contiguous, so a warp reads 256 contiguous bytes of a row; each
// thread keeps kSlots float64 sums in registers over a chunk of sequences,
// with kRowsInFlight rows' loads issued before their adds. The chunks of a
// window spread over blocks, their number from B and S (ops/correlation.py::
// power_split: many a window for GK self-diffusion's 32 x 48000, one for a
// system series' thousands of windows x 3); each chunk writes its partial
// row to a (B, chunks, F) float64 scratch, and acf_power_combine_kernel adds
// a window's partials in chunk order. No atomics: a run repeats bit for bit.
//
// Both take every size as int64 and index in int64 (a GK batch holds 1.6e9
// values). -fmad=false (see _build.py) keeps each square a rounded float32
// product; no FMA forms in the float64 adds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;      // pack: a tile's k extent and its columns
constexpr int kTileRows = 8;   // pack: the block is kTile x kTileRows threads
constexpr int kRun = 4;        // pack: k tiles a block packs in turn
constexpr int kPowerThreads = 128;
constexpr int kSlots = 5;      // power: columns a thread; kPowerThreads * kSlots is
                               // ops/correlation.py::POWER_COLUMNS
constexpr int kRowsInFlight = 4;

struct Pack {
  const float* x;    // (T, S)
  const int* lags;   // (R,) or null for lag_k = k
  float* buf;        // (n_win, S, fft_len)
  int64_t n_seq;     // S
  int64_t r, fft_len, first, stride, n_win;
  int64_t k_end;     // the tiles' end: fft_len with the tail, else R, rounded up to kTile
  int group;         // windows side by side in a tile: 1 where S > kTile / 2
  unsigned win_tiles, k_runs;  // the grid's decode in 32 bits (blocks < 2^31)
};

// Column c of tile (st, wt): its window b and sequence s, false where the
// column holds none (past S, or past the last window).
__device__ __forceinline__ bool column(const Pack& p, unsigned st, unsigned wt, int c, int64_t* b,
                                       int64_t* s) {
  if (p.group == 1) {
    *b = wt;
    *s = static_cast<int64_t>(st) * kTile + c;
    return *s < p.n_seq;
  }
  const int w = c / static_cast<int>(p.n_seq);  // n_seq <= kTile / 2 here
  *b = static_cast<int64_t>(wt) * p.group + w;
  *s = c - w * p.n_seq;
  return w < p.group && *b < p.n_win;
}

// One block packs kRun consecutive k tiles of one column tile: it decodes
// its tile once, and loads the next tile's values into registers before it
// stores the current one, so the loads' latency hides behind the stores.
__global__ void __launch_bounds__(kTile * kTileRows) acf_pack_kernel(Pack p) {
  constexpr int kPer = kTile / kTileRows;
  __shared__ float tile[kTile][kTile + 1];
  // 32-bit division: every thread decodes its block, and 64-bit divisions
  // cost more issue slots than the tile's loads and stores
  const unsigned wt = blockIdx.x % p.win_tiles;
  const unsigned rest = blockIdx.x / p.win_tiles;
  const unsigned run = rest % p.k_runs;
  const unsigned st = rest / p.k_runs;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int64_t b, s;
  const bool live = column(p, st, wt, tx, &b, &s);  // the column this thread reads
  const float* src = p.x + (p.first + b * p.stride) * p.n_seq + s;
  float* dst[kPer];  // the rows of the columns ty + i that this thread writes
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    int64_t bw, sw;
    dst[i] = column(p, st, wt, ty + i * kTileRows, &bw, &sw) ? p.buf + (bw * p.n_seq + sw) * p.fft_len
                                                              : nullptr;
  }
  int64_t k0 = static_cast<int64_t>(run) * kRun * kTile;
  const int64_t k_stop = k0 + kRun * kTile < p.k_end ? k0 + kRun * kTile : p.k_end;
  float v[kPer];
  auto load = [&](int64_t k_first) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t k = k_first + ty + i * kTileRows;
      v[i] = live && k < p.r ? src[(p.lags ? static_cast<int64_t>(p.lags[k]) : k) * p.n_seq] : 0.0f;
    }
  };
  load(k0);
  for (; k0 < k_stop; k0 += kTile) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) tile[ty + i * kTileRows][tx] = v[i];
    __syncthreads();
    if (k0 + kTile < k_stop) load(k0 + kTile);
    const int64_t k = k0 + tx;
    if (k < p.fft_len) {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (dst[i]) dst[i][k] = tile[tx][ty + i * kTileRows];
    }
    __syncthreads();
  }
}

struct Power {
  const float2* spec;  // (n_win, S, F)
  double* out;         // (n_win, F) where chunks == 1, else the (n_win, chunks, F) partials
  int64_t n_seq, n_freq, rows, chunks, col_width, col_tiles;
};

__global__ void __launch_bounds__(kPowerThreads) acf_power_sum_kernel(Power p) {
  const unsigned rest = blockIdx.x / static_cast<unsigned>(p.col_tiles);
  const int64_t tile = blockIdx.x % static_cast<unsigned>(p.col_tiles);
  const int64_t c = rest % static_cast<unsigned>(p.chunks);
  const int64_t b = rest / static_cast<unsigned>(p.chunks);
  const int64_t f_end = (tile + 1) * p.col_width < p.n_freq ? (tile + 1) * p.col_width : p.n_freq;
  const int64_t s0 = c * p.rows, s1 = s0 + p.rows < p.n_seq ? s0 + p.rows : p.n_seq;
  int64_t f[kSlots];
  bool live[kSlots];
  double acc[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    f[j] = tile * p.col_width + threadIdx.x + j * kPowerThreads;
    live[j] = f[j] < f_end;
    acc[j] = 0.0;
  }
  const float2* base = p.spec + b * p.n_seq * p.n_freq;
  int64_t s = s0;
  for (; s + kRowsInFlight <= s1; s += kRowsInFlight) {
    float2 v[kRowsInFlight][kSlots];
#pragma unroll
    for (int q = 0; q < kRowsInFlight; ++q) {
      const float2* row = base + (s + q) * p.n_freq;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) v[q][j] = live[j] ? __ldcs(row + f[j]) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < kRowsInFlight; ++q) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        acc[j] += static_cast<double>(__fmul_rn(v[q][j].x, v[q][j].x));
        acc[j] += static_cast<double>(__fmul_rn(v[q][j].y, v[q][j].y));
      }
    }
  }
  for (; s < s1; ++s) {
    const float2* row = base + s * p.n_freq;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (!live[j]) continue;
      const float2 v = __ldcs(row + f[j]);
      acc[j] += static_cast<double>(__fmul_rn(v.x, v.x));
      acc[j] += static_cast<double>(__fmul_rn(v.y, v.y));
    }
  }
  double* dst = p.out + (b * p.chunks + c) * p.n_freq;
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    if (live[j]) dst[f[j]] = acc[j];
}

// power[b, f] = the partials of window b at f, added in chunk order.
__global__ void acf_power_combine_kernel(const double* __restrict__ partial, double* __restrict__ power,
                                         int64_t n_win, int64_t chunks, int64_t n_freq) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_win * n_freq) return;
  const int64_t b = i / n_freq;
  const double* src = partial + b * chunks * n_freq + (i - b * n_freq);
  double sum = 0.0;
  for (int64_t c = 0; c < chunks; ++c) sum += src[c * n_freq];
  power[i] = sum;
}

constexpr int64_t kMaxGrid = 2147483647;  // gridDim.x

}  // namespace

extern "C" {

// Packs windows [0, n_win) of the (T, n_seq) float32 slab x, window b
// starting at frame first + b * stride, at lags 0..r-1 (lags null) or
// lags[0..r) (int32, each below the window's length: the caller checks),
// into buf (n_win, n_seq, fft_len) float32: the values at k < r, and the
// zeros at r <= k < fft_len where tail is 1 (else they are left as they
// are). Allocates nothing and does not synchronise; a CUDA error code.
int acf_pack_launch(const void* x, const void* lags, void* buf, int64_t n_seq, int64_t r,
                    int64_t fft_len, int64_t first, int64_t stride, int64_t n_win, int tail,
                    void* stream) {
  if (n_win <= 0 || n_seq <= 0) return cudaSuccess;
  Pack p{static_cast<const float*>(x), static_cast<const int*>(lags), static_cast<float*>(buf),
         n_seq, r, fft_len, first, stride, n_win, 0, 1, 0u, 0u};
  p.group = n_seq > kTile / 2 ? 1 : kTile / static_cast<int>(n_seq);
  const int64_t k_tiles = ((tail ? fft_len : r) + kTile - 1) / kTile;
  p.k_end = k_tiles * kTile;
  const int64_t win_tiles = (n_win + p.group - 1) / p.group;
  const int64_t k_runs = (k_tiles + kRun - 1) / kRun;
  const int64_t s_tiles = p.group == 1 ? (n_seq + kTile - 1) / kTile : 1;
  if (win_tiles > kMaxGrid || k_runs > kMaxGrid || s_tiles > kMaxGrid ||
      s_tiles * k_runs * win_tiles > kMaxGrid)
    return cudaErrorInvalidConfiguration;
  p.win_tiles = static_cast<unsigned>(win_tiles);
  p.k_runs = static_cast<unsigned>(k_runs);
  const int64_t blocks = s_tiles * k_runs * win_tiles;
  acf_pack_kernel<<<static_cast<unsigned>(blocks), dim3(kTile, kTileRows), 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// power (n_win, n_freq) float64 = the power of spec (n_win, n_seq, n_freq)
// complex64 summed over the n_seq sequences, in `chunks` chunks of `rows`
// sequences a window (chunks * rows >= n_seq > (chunks - 1) * rows). With
// chunks > 1, scratch holds n_win * chunks * n_freq doubles. Allocates
// nothing and does not synchronise; a CUDA error code.
int acf_power_sum_launch(const void* spec, void* power, void* scratch, int64_t n_win, int64_t n_seq,
                         int64_t n_freq, int64_t rows, int64_t chunks, void* stream) {
  if (n_win <= 0 || n_freq <= 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  Power p{static_cast<const float2*>(spec), static_cast<double*>(chunks > 1 ? scratch : power),
          n_seq, n_freq, rows, chunks, 0, 0};
  p.col_tiles = (n_freq + kPowerThreads * kSlots - 1) / (kPowerThreads * kSlots);
  p.col_width = (n_freq + p.col_tiles - 1) / p.col_tiles;
  const int64_t blocks = n_win * chunks * p.col_tiles;
  const int64_t combine = (n_win * n_freq + 255) / 256;
  if (blocks > kMaxGrid || combine > kMaxGrid) return cudaErrorInvalidConfiguration;
  acf_power_sum_kernel<<<static_cast<unsigned>(blocks), kPowerThreads, 0, s>>>(p);
  if (chunks > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    acf_power_combine_kernel<<<static_cast<unsigned>(combine), 256, 0, s>>>(
        static_cast<const double*>(scratch), static_cast<double*>(power), n_win, chunks, n_freq);
  }
  return cudaGetLastError();
}

}  // extern "C"
