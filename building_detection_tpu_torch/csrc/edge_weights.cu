// Edge-band weight maps for the training targets, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel edge_weight_maps_pallas
// (building_detection_tpu/kernels/pallas_morphology.py, body _edge_kernel,
// helper _win_filter).  For each (N, H, W) f32 label it takes a flat erosion
// and a flat dilation of width `win` (11 for the reference's 3x3 x5) with cv2
// border semantics (+inf / -inf outside the image) and writes
//   p_edge = weight where label - eroded == 1, else 1
//   f_edge = weight where dilated - label == 1, else 1.
//
// Bound: device memory.  Per pixel it must read 4 bytes and write 8: 25.2 MB
// at the trainer's (8, 512, 512), 7.5 us at 3.35 TB/s.  The arithmetic (two
// separable min/max passes) is far below the card's rate, so the design
// keeps the taps in registers, out of shared memory, cuts them to about
// three per output, and moves every byte in 16-byte vectors:
//
// * One block of 128 threads per (image, strip of kRows rows, chunk of up to
//   512 columns); a thread owns one float4 column quad.  Images up to 512
//   wide are one chunk, so a strip spans the full width and has only a
//   vertical halo; wider ones are cut into chunks that overlap by the
//   horizontal halo.
// * The window length is a template parameter (every win up to kMaxWindow is
//   instantiated), so both passes are unrolled over registers.
// * Vertical pass: the thread loads its quad of the strip's kRows + win - 1
//   input rows into registers (float4, read-only path) and takes each
//   output row's min and max over win of them by van Herk / Gil-Werman
//   (`sliding`: about three operations per output, not win - 1).  Only these
//   two results go to shared memory, once each per pixel.
// * Horizontal pass: the thread reads 2 x (2 x kHalo + 1) float4 of the row
//   around its quad from shared memory and slides the window over them in
//   registers the same way.  The label itself is still in registers from
//   the vertical pass.
// * Borders: a window clamped to the image has the same min and max as one
//   padded with +-inf, because the clamped part always contains the pixel's
//   own row and column.  So out-of-image rows are read as the nearest edge
//   row, and the shared-memory slots left and right of the image hold the
//   edge column's value.  No branch tests a border inside the taps.
// * Both outputs leave with streaming float4 stores (never read back here).
//   Where W is not a multiple of 4 or a pointer is not 16-byte aligned, the
//   same kernel loads and stores scalars, clamping column indices to the
//   image (the tail lanes of the last quad hold the edge column).
//
// Plain C entry point, loaded with ctypes: pointers and the stream as void*.
// Returns the CUDA error of the launch (0 on success).

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // one float4 column quad per thread
constexpr int kMaxWindow = 33;

// Output rows per strip: of 4, 8 and 16 rows, timed on an H100 at the
// trainer's (8, 512, 512), 16 was the fastest.
constexpr int kRows = 16;

template <int WIN>
struct Window {
  static constexpr int kLead = (WIN - 1) / 2;  // taps before the centre
  static constexpr int kTrail = WIN - 1 - kLead;  // taps after it (>= kLead)
  static constexpr int kHalo = (kTrail + 3) / 4;  // halo quads on each side
  static constexpr int kSlots = kThreads + 2 * kHalo;  // float4 slots a row
  static constexpr int kIn = kRows + WIN - 1;  // input rows a strip reads
  static constexpr size_t kSmemBytes = 2 * kRows * kSlots * sizeof(float4);
};

__device__ __forceinline__ float4 min4(float4 a, float4 b) {
  return make_float4(fminf(a.x, b.x), fminf(a.y, b.y), fminf(a.z, b.z), fminf(a.w, b.w));
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

__device__ __forceinline__ float4 splat(float v) { return make_float4(v, v, v, v); }

struct Min4 {
  __device__ float4 operator()(float4 a, float4 b) const { return min4(a, b); }
};
struct Max4 {
  __device__ float4 operator()(float4 a, float4 b) const { return max4(a, b); }
};
struct MinF {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// out[o] = op over v[kStart + o .. kStart + o + WIN - 1], o < OUT, by van
// Herk / Gil-Werman: cut v at kStart into blocks of WIN, take suffix results
// and prefix results within each block, and join one suffix with one prefix
// per output.  About three operations per output whatever WIN is; all
// indices are compile-time, so everything stays in registers.  min and max
// are exact, so the order of the taps does not change a bit.
template <int WIN, int OUT, int kStart, typename T, int N, typename Op>
__device__ __forceinline__ void sliding(const T (&v)[N], T (&out)[OUT], Op op) {
  static_assert(kStart + OUT + WIN - 2 < N, "window past the input");
  T suf[N];
  T pre[N];
#pragma unroll
  for (int j = N - 1; j >= kStart; --j) {
    suf[j] = ((j - kStart + 1) % WIN == 0 || j == N - 1) ? v[j] : op(v[j], suf[j + 1 < N ? j + 1 : j]);
  }
#pragma unroll
  for (int j = kStart; j < N; ++j) {
    pre[j] = ((j - kStart) % WIN == 0) ? v[j] : op(pre[j > 0 ? j - 1 : 0], v[j]);
  }
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    out[o] = (o % WIN == 0) ? suf[kStart + o] : op(suf[kStart + o], pre[kStart + o + WIN - 1]);
  }
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Columns 4q..4q+3 of one row; past the last column, the last column.
__device__ __forceinline__ float4 load_quad(const float* row, int q, int w, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(row) + q);
  const int x = 4 * q;
  return make_float4(__ldg(row + min(x, w - 1)), __ldg(row + min(x + 1, w - 1)),
                     __ldg(row + min(x + 2, w - 1)), __ldg(row + min(x + 3, w - 1)));
}

__device__ __forceinline__ void store_quad(float* row, int q, int w, bool vec, float4 v) {
  if (vec) {
    __stcs(reinterpret_cast<float4*>(row) + q, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (4 * q + i < w) __stcs(row + 4 * q + i, lane(v, i));
  }
}

template <int WIN>
__global__ void __launch_bounds__(kThreads)
    edge_weight_kernel(const float* __restrict__ label, float* __restrict__ f_edge,
                       float* __restrict__ p_edge, int h, int w, int strips, int chunks,
                       float weight) {
  using C = Window<WIN>;
  extern __shared__ float4 smem[];
  float4* lo = smem;                   // kRows x kSlots: vertical min
  float4* hi = smem + kRows * C::kSlots;  // kRows x kSlots: vertical max

  int b = blockIdx.x;
  const int chunk = b % chunks;
  b /= chunks;
  const int strip = b % strips;
  const int img = b / strips;

  const int nq = (w + 3) >> 2;
  // Output quads of this chunk, and the quad of thread 0: one chunk covers
  // the whole width; several overlap by kHalo quads on each side.
  const int step = chunks == 1 ? nq : kThreads - 2 * C::kHalo;
  const int out0 = chunk * step;
  const int out1 = min(out0 + step, nq);
  const int base = chunks == 1 ? 0 : out0 - C::kHalo;
  const int q = base + static_cast<int>(threadIdx.x);
  const int slot = threadIdx.x + C::kHalo;  // shared-memory slot of quad q
  const int r0 = strip * kRows;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* src = label + img * plane;
  const bool vec = (w & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(label) | reinterpret_cast<uintptr_t>(f_edge) |
                     reinterpret_cast<uintptr_t>(p_edge)) & 15) == 0;

  float4 in[C::kIn];
  if (q >= 0 && q < nq) {
#pragma unroll
    for (int j = 0; j < C::kIn; ++j) {
      const int r = min(max(r0 - C::kLead + j, 0), h - 1);
      in[j] = load_quad(src + static_cast<size_t>(r) * w, q, w, vec);
    }
    float4 vmin[kRows];
    float4 vmax[kRows];
    sliding<WIN, kRows, 0>(in, vmin, Min4());
    sliding<WIN, kRows, 0>(in, vmax, Max4());
#pragma unroll
    for (int y = 0; y < kRows; ++y) {
      const float4 mn = vmin[y];
      const float4 mx = vmax[y];
      float4* lrow = lo + y * C::kSlots;
      float4* hrow = hi + y * C::kSlots;
      lrow[slot] = mn;
      hrow[slot] = mx;
      if (q == 0) {
#pragma unroll
        for (int p = 1; p <= C::kHalo; ++p) {
          lrow[slot - p] = splat(mn.x);
          hrow[slot - p] = splat(mx.x);
        }
      }
      if (q == nq - 1) {  // lane w: column w - 1 on both the vector and scalar paths
#pragma unroll
        for (int p = 1; p <= C::kHalo; ++p) {
          lrow[slot + p] = splat(mn.w);
          hrow[slot + p] = splat(mx.w);
        }
      }
    }
  }
  __syncthreads();

  if (q < out0 || q >= out1) return;
  const size_t out_base = img * plane;
#pragma unroll
  for (int y = 0; y < kRows; ++y) {
    if (r0 + y >= h) break;
    float vlo[4 * (2 * C::kHalo + 1)];
    float vhi[4 * (2 * C::kHalo + 1)];
#pragma unroll
    for (int s = 0; s <= 2 * C::kHalo; ++s) {
      const float4 a = lo[y * C::kSlots + slot - C::kHalo + s];
      const float4 c = hi[y * C::kSlots + slot - C::kHalo + s];
      vlo[4 * s] = a.x, vlo[4 * s + 1] = a.y, vlo[4 * s + 2] = a.z, vlo[4 * s + 3] = a.w;
      vhi[4 * s] = c.x, vhi[4 * s + 1] = c.y, vhi[4 * s + 2] = c.z, vhi[4 * s + 3] = c.w;
    }
    // lane i's window starts at tap 4 * kHalo - kLead + i of vlo / vhi
    float mn[4], mx[4];
    sliding<WIN, 4, 4 * C::kHalo - C::kLead>(vlo, mn, MinF());
    sliding<WIN, 4, 4 * C::kHalo - C::kLead>(vhi, mx, MaxF());
    const float4 x = in[y + C::kLead];
    float pe[4], fe[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xi = lane(x, i);
      pe[i] = (xi - mn[i] == 1.0f) ? weight : 1.0f;
      fe[i] = (mx[i] - xi == 1.0f) ? weight : 1.0f;
    }
    const size_t row = out_base + static_cast<size_t>(r0 + y) * w;
    store_quad(p_edge + row, q, w, vec, make_float4(pe[0], pe[1], pe[2], pe[3]));
    store_quad(f_edge + row, q, w, vec, make_float4(fe[0], fe[1], fe[2], fe[3]));
  }
}

// Lets edge_weight_kernel<WIN> take its shared memory where that is above the
// 48 KB a block may take by default: one driver call per device, on the first
// launch there, not on every launch.
template <int WIN>
cudaError_t allow_smem(int device) {
  using C = Window<WIN>;
  if (C::kSmemBytes <= 48 * 1024) return cudaSuccess;
  static std::atomic<unsigned long long> done{0};  // bit d: set on device d (< 64)
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      edge_weight_kernel<WIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmemBytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int WIN>
int launch(const float* label, float* f_edge, float* p_edge, int n, int h, int w, float weight,
           int device, cudaStream_t stream) {
  using C = Window<WIN>;
  const int nq = (w + 3) / 4;
  const int step = kThreads - 2 * C::kHalo;
  const int chunks = nq <= kThreads ? 1 : (nq + step - 1) / step;
  const int strips = (h + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(n) * strips * chunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = allow_smem<WIN>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_weight_kernel<WIN><<<static_cast<unsigned>(blocks), kThreads, C::kSmemBytes, stream>>>(
      label, f_edge, p_edge, h, w, strips, chunks, weight);
  return static_cast<int>(cudaGetLastError());
}

template <int WIN>
int dispatch(int win, const float* label, float* f_edge, float* p_edge, int n, int h, int w,
             float weight, int device, cudaStream_t stream) {
  if (win == WIN) return launch<WIN>(label, f_edge, p_edge, n, h, w, weight, device, stream);
  if constexpr (WIN < kMaxWindow) {
    return dispatch<WIN + 1>(win, label, f_edge, p_edge, n, h, w, weight, device, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int bdt_edge_weight_maps(const void* label, void* f_edge, void* p_edge, int n, int h,
                                    int w, int win, float weight, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch<1>(win, static_cast<const float*>(label), static_cast<float*>(f_edge),
                     static_cast<float*>(p_edge), n, h, w, weight, device,
                     static_cast<cudaStream_t>(stream));
}
