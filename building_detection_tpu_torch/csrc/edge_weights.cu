// Edge-band weight maps for the training targets, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel edge_weight_maps_pallas
// (building_detection_tpu/kernels/pallas_morphology.py, body _edge_kernel).
// For each (N, H, W) f32 label in {0,1} it takes a flat erosion and a flat
// dilation of width `win` (11 for the reference's 3x3 x5) with cv2 border
// semantics (+inf / -inf outside the image) and writes
//   p_edge = weight where label - eroded == 1, else 1
//   f_edge = weight where dilated - label == 1, else 1.
//
// Bound: device memory.  Per pixel it reads 4 bytes and writes 8, about
// 25 MB at the training shape (8, 512, 512); the 2 x win min/max taps per
// pixel run from shared memory.  Design: one block per (image, 32x32 output
// tile).  The block loads its (32 + win - 1)^2 input window once into shared
// memory (two copies, one padded with +inf for the erosion and one with -inf
// for the dilation), takes a vertical then a horizontal win-tap min and max,
// and writes both maps, so each input pixel is read from device memory about
// (1 + (win - 1) / 32)^2 times and each output written once.  The TPU
// kernel's roll-and-mask log decomposition is a VPU device with no use here.
//
// Plain C entry point, loaded with ctypes: pointers and the stream as void*.
// Returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__global__ void edge_weight_kernel(const float* __restrict__ label,
                                   float* __restrict__ f_edge,
                                   float* __restrict__ p_edge, int h, int w,
                                   int win, float weight) {
  extern __shared__ float smem[];
  const int lead = (win - 1) / 2;  // window taps before the centre pixel
  const int span = kTile + win - 1;
  float* lo = smem;               // span x span, +inf outside the image
  float* hi = lo + span * span;   // span x span, -inf outside the image
  float* vlo = hi + span * span;  // kTile x span: vertical min
  float* vhi = vlo + kTile * span;  // kTile x span: vertical max

  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* src = label + blockIdx.z * plane;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int i = tid; i < span * span; i += nthreads) {
    const int yy = y0 - lead + i / span;
    const int xx = x0 - lead + i % span;
    const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const float v = inside ? src[static_cast<size_t>(yy) * w + xx] : 0.0f;
    lo[i] = inside ? v : CUDART_INF_F;
    hi[i] = inside ? v : -CUDART_INF_F;
  }
  __syncthreads();

  for (int i = tid; i < kTile * span; i += nthreads) {
    const int ty = i / span;
    const int cx = i % span;
    float mn = CUDART_INF_F;
    float mx = -CUDART_INF_F;
    for (int k = 0; k < win; ++k) {
      mn = fminf(mn, lo[(ty + k) * span + cx]);
      mx = fmaxf(mx, hi[(ty + k) * span + cx]);
    }
    vlo[i] = mn;
    vhi[i] = mx;
  }
  __syncthreads();

  for (int i = tid; i < kTile * kTile; i += nthreads) {
    const int ty = i / kTile;
    const int tx = i % kTile;
    const int yy = y0 + ty;
    const int xx = x0 + tx;
    if (yy >= h || xx >= w) continue;
    float mn = CUDART_INF_F;
    float mx = -CUDART_INF_F;
    for (int k = 0; k < win; ++k) {
      mn = fminf(mn, vlo[ty * span + tx + k]);
      mx = fmaxf(mx, vhi[ty * span + tx + k]);
    }
    const float x = lo[(ty + lead) * span + tx + lead];
    const size_t o = blockIdx.z * plane + static_cast<size_t>(yy) * w + xx;
    p_edge[o] = (x - mn == 1.0f) ? weight : 1.0f;
    f_edge[o] = (mx - x == 1.0f) ? weight : 1.0f;
  }
}

}  // namespace

extern "C" int bdt_edge_weight_maps_smem_bytes(int win) {
  const int span = kTile + win - 1;
  return static_cast<int>((2 * span * span + 2 * kTile * span) * sizeof(float));
}

extern "C" int bdt_edge_weight_maps(const void* label, void* f_edge,
                                    void* p_edge, int n, int h, int w, int win,
                                    float weight, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  const size_t smem = bdt_edge_weight_maps_smem_bytes(win);
  edge_weight_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(label), static_cast<float*>(f_edge),
      static_cast<float*>(p_edge), h, w, win, weight);
  return static_cast<int>(cudaGetLastError());
}
