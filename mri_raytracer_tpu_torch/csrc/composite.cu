// Kernel K1: fused front-to-back shear-warp compositor, CUDA C++ for sm_90a.
//
// Replaces mri_raytracer_tpu/ops/pallas_composite.py::_make_kernel (launched
// by sweep_composite_pallas, pallas_composite.py:575), with both of its
// overlay sources: K1a, the seg and baked-pred nearest rows, and K1b, the
// mode-2 prediction field (pallas_composite.py:72-89, 124-135, 317-322);
// and with its executed-plane counter, K1c (echo='planes', below). Its
// plain PyTorch version is
// mri_raytracer_tpu_torch/ops/composite.py::composite_planes_plain; the
// arithmetic below follows it operation by operation.
//
// Design. One thread per intermediate pixel (i, j). A block covers kThreads
// consecutive columns j of one row i, so a warp's threads share i, hence the
// a-rows floor(pos_a(i)) they read, and their t1b reads are coalesced along
// O. The (K, 7) plane table (~7 KB at K = 257) sits in shared memory; the
// grayscale sum, the three label colour sums, T and the per-ray 'started'
// flag stay in registers across all K planes, so nothing but the final
// pixel is written. Per plane a thread reads 2 bf16 taps of t1b (the a-axis
// lerp that finishes the separable resample; an out-of-range tap of a
// cropped volume has no weight and is never clamped back) plus one uint8
// label per overlay. A ray leaves the loop once T <= 0.01: every later
// plane has act = 0, the same result as the TPU kernel's tile culling.
//
// K1b. The field is (ceil(K / Kf), Op, Op) uint8 with Op = O / S: plane m
// reads row m / Kf at (i / S, j / S), the TPU kernel's floor one-hot
// upsampling along planes, rows and columns. The tap depends on the pixel
// alone, so it is gated by the plane's activity only, not by the a-row
// range check of the row overlays. The TPU kernel streamed the field as a
// second DMA stream, zero-padded to 128 lanes; here a warp's 32 threads
// read 32 / S neighbouring bytes of one field row, which stay in L1/L2
// across the S rows i that share it.
//
// K1c. The TPU kernel's echo='planes' counter (pallas_composite.py:111,
// 328-336, 351-353) counted, per (tile_i x O) tile, the planes whose
// compute ran, and wrote that count in T's slot. Here the count is per
// pixel: the planes whose act test passed, i.e. the (pixel, plane) pairs
// that composited, the work these inputs need whatever tiles a compositor
// uses. The TPU tile count bounds it from above, tile by tile (it charges
// every pixel of a running tile and ignores the clip and pre-entry
// gates). It is a template flag, as the TPU kernel's was static: the
// launch without a counter compiles to the same code as before, and the
// counting launch writes an extra (O, O) int32 map beside C and T.
//
// Bound. Bytes: the stage-1 rows, 2 + 1 (+1) bytes per (plane, a-row,
// column), read once, the field once, plus three (O, O) maps in and 4
// floats per pixel out (and 4 bytes more with the counter). Operations:
// ~40 fp32 operations and one expf per active (pixel, plane), 3 more for
// the nearest label row when a row overlay is on, and ~14 with one expf per
// overlay tap whose label is in [1, 8) (label 0 is skipped). The TPU
// kernel's fast/slow entry paths are one path here: the entry correction is
// a few flops per pixel.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <bool kCount>
__global__ void __launch_bounds__(kThreads) composite_kernel(
    const __nv_bfloat16* __restrict__ t1b,  // (K, Na, O)
    const uint8_t* __restrict__ seg_rows,   // (K, Na, O) or null
    const uint8_t* __restrict__ pred_rows,  // (K, Na, O) or null
    const uint8_t* __restrict__ field,      // (ceil(K/Kf), Op, Op) or null
    const float* __restrict__ pp,           // (K, 7)
    const float* __restrict__ sc,           // (16,)
    const float* __restrict__ lut,          // (8, 4), row 0 transparent
    const float* __restrict__ vmag,         // (O, O)
    const float* __restrict__ dt_map,       // (O, O)
    const float* __restrict__ r_map,        // (O, O)
    float* __restrict__ C,                  // (O, O, 3)
    float* __restrict__ T_out,              // (O, O)
    int32_t* __restrict__ planes,           // (O, O), written when kCount
    int K, int Na, int O, int S, int Kf, int Op, int use_gamma,
    int use_clip) {
  extern __shared__ float s_pp[];
  __shared__ float s_lut[32];
  for (int t = threadIdx.x; t < K * 7; t += blockDim.x) s_pp[t] = pp[t];
  if (threadIdx.x < 32) s_lut[threadIdx.x] = lut[threadIdx.x];
  __syncthreads();

  const int i = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= O) return;

  const float ww = sc[0], wl = sc[1], gamma = sc[2], ia = sc[3];
  const float near_t = sc[4], far_t = sc[5];
  const float show_seg = sc[6], show_pred = sc[7];
  const float mask_b_lo = sc[8], mask_b_hi = sc[9];
  const float a_clamp_lo = sc[10], a_clamp_hi = sc[11];
  const float a_clamp_hi_n = sc[12];
  const float mask_a_lo = sc[13], mask_a_hi = sc[14];
  const float lo = wl - 0.5f * ww;
  const float inv_ww = 1.0f / ww;

  const size_t pix = (size_t)i * O + j;
  const float dt = dt_map[pix];
  const float r = r_map[pix];
  const float vm = vmag[pix];
  const float fi = (float)i;
  const float fj = (float)j;
  const size_t plane = (size_t)Na * O;
  // This pixel's field tap within a field row (K1b).
  const size_t fpix = (size_t)(i / S) * Op + (size_t)(j / S);

  float cg = 0.f, lr = 0.f, lg = 0.f, lb = 0.f, T = 1.f;
  bool started = false;
  int n_planes = 0;  // K1c: planes that composited
  for (int m = 0; m < K && T > 0.01f; ++m) {
    const float* q = s_pp + 7 * m;
    const float off_a = q[0], sc_a = q[1], off_b = q[2], sc_b = q[3];
    const float lam = q[4], own = q[5], q_m = q[6];
    // Rounded as the plain version rounds them (no fused multiply-add):
    // the box masks compare these positions with the box edges exactly, and
    // a field label on an edge pixel shows whether that plane counted.
    const float pos_a = __fadd_rn(off_a, __fmul_rn(fi, sc_a));
    const float pos_b = __fadd_rn(off_b, __fmul_rn(fj, sc_b));
    bool act = pos_a >= mask_a_lo && pos_a <= mask_a_hi &&
               pos_b >= mask_b_lo && pos_b <= mask_b_hi && own > 0.f;
    if (use_clip) {
      const float t_k = lam * vm;
      act = act && t_k >= near_t && t_k <= far_t;
    } else {
      act = act && lam >= 0.f;  // planes behind the eye
    }
    // Pre-entry gate; r >= 1e37 is the "no entry correction" sentinel.
    const float g = q_m - r;
    act = act && (g >= -1e-3f || r >= 1e37f);
    if (!act) continue;
    if (kCount) ++n_planes;

    // The ray's first active plane extends its dt by the entry->crossing
    // distance g (clipped to [0, 2]; g >= 2 means no correction).
    const float corr = g < 2.f ? fminf(fmaxf(g, 0.f), 2.f) : 0.f;
    const float dt_e = dt * (1.f + corr * (started ? 0.f : 1.f));
    started = true;

    // a-axis lerp of the stage-1 rows.
    const float qa = fminf(fmaxf(pos_a, a_clamp_lo), a_clamp_hi);
    const float a0f = floorf(qa);
    const float fa = qa - a0f;
    const int a0 = (int)a0f;
    const __nv_bfloat16* col = t1b + (size_t)m * plane + j;
    const float x0 =
        (a0 >= 0 && a0 < Na) ? __bfloat162float(col[(size_t)a0 * O]) : 0.f;
    const float x1 = (a0 + 1 >= 0 && a0 + 1 < Na)
                         ? __bfloat162float(col[(size_t)(a0 + 1) * O])
                         : 0.f;
    const float v = (1.f - fa) * x0 + fa * x1;

    float val = fminf(fmaxf((v - lo) * inv_ww, 0.f), 1.f);
    if (use_gamma) val = powf(val, gamma);
    const float aI = 1.f - expf(-val * ia * dt_e);
    cg = cg + aI * T * val;
    T = T * (1.f - aI);

    // Label LUT overlays, in the TPU kernel's order: seg at 1x opacity,
    // then pred at 1.5x from its baked rows or from the field. Label 0 (and
    // anything outside [1, 8)) is transparent and changes nothing.
    int labs[2] = {0, 0};
    if (seg_rows != nullptr || pred_rows != nullptr) {
      const int an =
          (int)rintf(fminf(fmaxf(pos_a, a_clamp_lo), a_clamp_hi_n));
      if (an >= 0 && an < Na) {
        const size_t off = (size_t)m * plane + (size_t)an * O + j;
        if (seg_rows != nullptr) labs[0] = seg_rows[off];
        if (pred_rows != nullptr) labs[1] = pred_rows[off];
      }
    }
    if (field != nullptr) labs[1] = field[(size_t)(m / Kf) * Op * Op + fpix];
    const float rates[2] = {1.f, 1.5f};
    const float shows[2] = {show_seg, show_pred};
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int lab = labs[o];
      if (lab <= 0 || lab >= 8) continue;
      const float* c = s_lut + 4 * lab;
      const float aS = (1.f - expf(-c[3] * dt_e * rates[o])) * shows[o];
      const float w = aS * T;
      lr = lr + w * c[0];
      lg = lg + w * c[1];
      lb = lb + w * c[2];
      T = T * (1.f - aS);
    }
  }
  C[pix * 3 + 0] = cg + lr;
  C[pix * 3 + 1] = cg + lg;
  C[pix * 3 + 2] = cg + lb;
  T_out[pix] = T;
  if (kCount) planes[pix] = n_planes;
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success).
// field may be null (then S, Kf, Op are unused); pred_rows and field are
// never both given. planes may be null (K1 without the counter); given, the
// counting variant writes each pixel's executed-plane count there (K1c).
extern "C" int mrt_composite(const void* t1b, const void* seg_rows,
                             const void* pred_rows, const void* field,
                             const void* pp, const void* sc, const void* lut,
                             const void* vmag, const void* dt_map,
                             const void* r_map, void* C, void* T,
                             void* planes, int K, int Na, int O, int S,
                             int Kf, int Op, int use_gamma, int use_clip,
                             void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((O + kThreads - 1) / kThreads, O);
  const size_t smem = (size_t)K * 7 * sizeof(float);
  auto kernel = planes != nullptr ? composite_kernel<true>
                                  : composite_kernel<false>;
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)t1b, (const uint8_t*)seg_rows,
      (const uint8_t*)pred_rows, (const uint8_t*)field, (const float*)pp,
      (const float*)sc, (const float*)lut, (const float*)vmag,
      (const float*)dt_map, (const float*)r_map, (float*)C, (float*)T,
      (int32_t*)planes, K, Na, O, field != nullptr ? S : 1,
      field != nullptr ? Kf : 1, field != nullptr ? Op : 0, use_gamma,
      use_clip);
  return (int)cudaGetLastError();
}
