// Kernel K2: homography warp of the composited intermediate to the screen,
// CUDA C++ for sm_90a.
//
// Replaces mri_raytracer_tpu/ops/pallas_warp.py::_make_warp_kernel (launched
// by warp_pallas_exec, pallas_warp.py:222). Its plain PyTorch version is
// mri_raytracer_tpu_torch/ops/warp.py::warp_screen_plain (the gather warp of
// shearwarp.py:733-780, 808-809); the arithmetic below follows it operation
// by operation.
//
// Bound. Bytes: the part of the (O, O, 3) intermediate that valid pixels
// touch, read once, and the (H, W, 3) frame written once (~22 MB at 1024^2);
// ~60 fp32 operations per pixel.
//
// Design. The screen is cut into kTileW x kTileH tiles; a block of kThreads
// walks a share of them (a persistent grid: as many blocks as fit on the
// card at once). A warp's 32 lanes cover a kWarpW x (32 / kWarpW) patch of
// the screen, and each thread kPix pixels stacked down the column, so every
// load instruction of a warp reads the corners of a compact patch: under
// any rotation of the homography its rows of C stay few (a row of 32
// pixels at 45 degrees spans ~15 rows of C, an 8 x 4 patch ~6), and the
// thread's kPix pixels give it kPix independent rays. Per pixel it computes
// its ray's hit on the base plane from the packed camera and the sweep
// scalars, which the thread reads once into registers. The maps round as
// PyTorch's CUDA operations round them (__fmul_rn/__fadd_rn: no fused
// multiply-add, and the division by the screen size as a product with its
// reciprocal), so `valid` is the plain version's bit for bit. A pixel off
// the intermediate loads nothing and writes the background. When
// W % 4 == 0 (the wide instantiation) the warp's rows of kWarpW pixels pass
// through shared memory and leave as float4 stores of consecutive lanes;
// otherwise each channel is stored alone.
//
// Loads. The corners are gathered through L1, a thread's loads all issued
// before any blend. Staging each tile's source box of C in shared memory by
// cp.async, once or double-buffered, and gathering from there measured
// slower (PERF.md section 6). At most 80 registers a thread give 6 blocks an
// SM. Two pixels a thread measured within 1% of 4 at each of the six
// poses of chip_smoke.py and 1.7% faster in their geometric mean; 1 and 8
// were slower, and per-channel stores 1-9% slower than the float4 ones.
// What is left (tools/k2_ablation.py): the frame's stores take about what a
// fill of it takes, and the gathers through L1 most of the rest.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPix = 2;    // pixels a thread, down its column
constexpr int kWarpW = 8;  // a warp's patch: kWarpW x kWarpH pixels a load
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kWarpH = 32 / kWarpW;
constexpr int kWarpRows = kWarpH * kPix;  // rows of a warp's part of a tile
constexpr int kWarpsX = kTileW / kWarpW;
constexpr int kWarpsY = kTileH / kWarpRows;
constexpr int kThreads = 32 * kWarpsX * kWarpsY;
static_assert(kWarpW % 4 == 0 && 32 % kWarpW == 0 && kTileW % kWarpW == 0 &&
                  kTileH % kWarpRows == 0,
              "tile shape");
constexpr int kMinBlocks = 6;

// Scalar vector layout (ops/warp.py): [0:13) packed camera (eye, right, up,
// forward, fov_y), 13 w_base, [14:17) eye permuted (k, a, b), 17 a0, 18 da,
// 19 b0, 20 db, [21:24) background colour.
struct Frame {
  float R[3], U[3], F[3];  // right, up, forward permuted (k, a, b)
  float f, aspect, inv_w, inv_h;
  float num;  // w_base - e_k
  float ea, eb, a0, da, b0, db, top;
  float bg[3];
};

__device__ __forceinline__ Frame load_frame(const float* __restrict__ s,
                                            int axis, float aspect, int O,
                                            int H, int W) {
  // Sweep-axis permutation {0: (0,1,2), 1: (1,0,2), 2: (2,0,1)}.
  const int o[3] = {axis, axis == 0 ? 1 : 0, axis == 2 ? 1 : 2};
  Frame fr;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    fr.R[c] = __ldg(s + 3 + o[c]);
    fr.U[c] = __ldg(s + 6 + o[c]);
    fr.F[c] = __ldg(s + 9 + o[c]);
    fr.bg[c] = __ldg(s + 21 + c);
  }
  fr.f = 1.f / tanf(0.5f * __ldg(s + 12));
  fr.aspect = aspect;
  fr.inv_w = 1.f / (float)W;
  fr.inv_h = 1.f / (float)H;
  fr.num = __ldg(s + 13) - __ldg(s + 14);
  fr.ea = __ldg(s + 15);
  fr.eb = __ldg(s + 16);
  fr.a0 = __ldg(s + 17);
  fr.da = __ldg(s + 18);
  fr.b0 = __ldg(s + 19);
  fr.db = __ldg(s + 20);
  fr.top = (float)(O - 1);
  return fr;
}

// cx of screen column x and cy of screen row y (ops/warp.py:screen_maps).
__device__ __forceinline__ float ray_cx(const Frame& fr, int x) {
  const float xs = __fmul_rn(__fmul_rn((float)x + 0.5f, fr.inv_w), 2.f) - 1.f;
  return __fmul_rn(xs, fr.aspect) / fr.f;
}

__device__ __forceinline__ float ray_cy(const Frame& fr, int y) {
  const float ys = __fmul_rn(__fmul_rn((float)y + 0.5f, fr.inv_h), 2.f) - 1.f;
  return -ys / fr.f;
}

// One ray's unclamped maps: returns t_base, sets i_map, j_map.
__device__ __forceinline__ float ray_maps(const Frame& fr, float cx, float cy,
                                          float& i_map, float& j_map) {
  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    d[c] = __fadd_rn(__fadd_rn(__fmul_rn(cx, fr.R[c]), __fmul_rn(cy, fr.U[c])),
                     fr.F[c]);
  const float denom = fabsf(d[0]) < 1e-6f ? 1e-6f : d[0];
  const float t_base = fr.num / denom;
  const float hit_a = __fadd_rn(fr.ea, __fmul_rn(t_base, d[1]));
  const float hit_b = __fadd_rn(fr.eb, __fmul_rn(t_base, d[2]));
  i_map = __fsub_rn(hit_a, fr.a0) / fr.da;
  j_map = __fsub_rn(hit_b, fr.b0) / fr.db;
  return t_base;
}

// Stores a warp's kWarpRows rows of kWarpW pixels from (xw, yw); the lane
// at (lx, ly) of the patch holds pixel (xw + lx, yw + ly + kWarpH * p) in
// v[3p:3p+3]. Wide: through `buf` (the warp's 32 * kPix * 3 floats of
// shared memory, row-major) as float4s of consecutive lanes, which needs
// W % 4 == 0 and `out` 16-byte aligned.
template <bool kWide>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           float* buf, int W, int H, int xw,
                                           int yw, int lx, int ly,
                                           const float (&v)[3 * kPix]) {
  if constexpr (kWide) {
    constexpr int kRow4 = kWarpW * 3 / 4;  // float4s of a row
    const int lane = ly * kWarpW + lx;
#pragma unroll
    for (int p = 0; p < kPix; ++p)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        buf[((ly + kWarpH * p) * kWarpW + lx) * 3 + c] = v[3 * p + c];
    __syncwarp();
    const int n4 = min(kWarpW, W - xw) * 3 / 4;
    const float4* b4 = reinterpret_cast<const float4*>(buf);
#pragma unroll
    for (int f = lane; f < kWarpRows * kRow4; f += 32) {
      const int r = f / kRow4, col = f % kRow4;
      if (col < n4 && yw + r < H)
        reinterpret_cast<float4*>(out + ((size_t)(yw + r) * W + xw) * 3)[col] =
            b4[f];
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int x = xw + lx, y = yw + ly + kWarpH * p;
      if (x < W && y < H) {
        float* o = out + ((size_t)y * W + x) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) o[c] = v[3 * p + c];
      }
    }
  }
}

// kWide: W % 4 == 0 and `out` 16-byte aligned.
template <bool kWide>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    warp_kernel(const float* __restrict__ C, const float* __restrict__ s,
                float* __restrict__ out, int O, int H, int W, int axis,
                float aspect, int tiles_x, int tiles) {
  __shared__ __align__(16) float s_rows[kThreads / 32][32 * kPix * 3];
  const Frame fr = load_frame(s, axis, aspect, O, H, W);
  const int n_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                      (int)gridDim.x;
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  const int lx = lane % kWarpW, ly = lane / kWarpW;
  const int wx = warp % kWarpsX * kWarpW, wy = warp / kWarpsX * kWarpRows;
  for (int k = 0; k < n_tiles; ++k) {
    const int tile = (int)blockIdx.x + k * (int)gridDim.x;
    const int xw = (tile % tiles_x) * kTileW + wx;  // the warp's first column
    const int yw = (tile / tiles_x) * kTileH + wy;  // and row
    if (xw >= W || yw >= H) continue;  // uniform over the warp
    const int x = xw + lx;
    // Maps, corner offsets and weights of the thread's pixels.
    const float cx = ray_cx(fr, x);
    int off[kPix];
    bool valid[kPix];
    float w[kPix][4];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      float i_map, j_map;
      const int y = yw + ly + kWarpH * p;
      const float t_base = ray_maps(fr, cx, ray_cy(fr, y), i_map, j_map);
      valid[p] = x < W && y < H && t_base > 0.f && i_map >= 0.f &&
                 i_map <= fr.top && j_map >= 0.f && j_map <= fr.top;
      i_map = fminf(fmaxf(i_map, 0.f), fr.top);
      j_map = fminf(fmaxf(j_map, 0.f), fr.top);
      const int i0 = min(max((int)floorf(i_map), 0), O - 2);
      const int j0 = min(max((int)floorf(j_map), 0), O - 2);
      const float fi = fminf(fmaxf(i_map - (float)i0, 0.f), 1.f);
      const float fj = fminf(fmaxf(j_map - (float)j0, 0.f), 1.f);
      w[p][0] = (1.f - fi) * (1.f - fj);
      w[p][1] = (1.f - fi) * fj;
      w[p][2] = fi * (1.f - fj);
      w[p][3] = fi * fj;
      off[p] = (i0 * O + j0) * 3;
    }
    // Every corner load of the thread's pixels, before any blend.
    float q[kPix][12];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
#pragma unroll
      for (int e = 0; e < 12; ++e) q[p][e] = 0.f;
      if (valid[p]) {
        const float* q0 = C + off[p];
        const float* q1 = q0 + (size_t)O * 3;
#pragma unroll
        for (int e = 0; e < 6; ++e) {
          q[p][e] = __ldg(q0 + e);
          q[p][6 + e] = __ldg(q1 + e);
        }
      }
    }
    float v[3 * kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float lerp = q[p][c] * w[p][0] + q[p][3 + c] * w[p][1] +
                           q[p][6 + c] * w[p][2] + q[p][9 + c] * w[p][3];
        v[3 * p + c] = fr.bg[c] + (valid[p] ? lerp : 0.f);
      }
    store_rows<kWide>(out, s_rows[warp], W, H, xw, yw, lx, ly, v);
  }
}

template <bool kWide>
int launch(const float* C, const float* s, float* out, int O, int H, int W,
           int axis, float aspect, cudaStream_t stream) {
  // Blocks resident on the card at once, per device, found at first use.
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int& n = resident[dev & 63];
  if (n == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, warp_kernel<kWide>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    n = sms * per_sm;
  }
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((H + kTileH - 1) / kTileH);
  const int grid = tiles < n ? tiles : n;
  warp_kernel<kWide><<<grid, kThreads, 0, stream>>>(
      C, s, out, O, H, W, axis, aspect, tiles_x, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int mrt_warp(const void* C, const void* s, void* out, int O,
                        int H, int W, int axis, float aspect, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const bool wide =
      W % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  return (wide ? launch<true> : launch<false>)(
      (const float*)C, (const float*)s, (float*)out, O, H, W, axis, aspect,
      (cudaStream_t)stream);
}

// K2's shape and resources, for reports: out[0:4] = kTileW, kTileH, kPix,
// kThreads; then for the wide and the scalar instantiation, blocks per SM,
// registers and local bytes (stack frame and spills). Returns a cudaError.
extern "C" int mrt_warp_info(int* out) {
  out[0] = kTileW;
  out[1] = kTileH;
  out[2] = kPix;
  out[3] = kThreads;
  const void* fns[2] = {(const void*)warp_kernel<true>,
                        (const void*)warp_kernel<false>};
  for (int v = 0; v < 2; ++v) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fns[v]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4 + 3 * v],
                                                          fns[v], kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    out[5 + 3 * v] = attr.numRegs;
    out[6 + 3 * v] = (int)attr.localSizeBytes;
  }
  return 0;
}
