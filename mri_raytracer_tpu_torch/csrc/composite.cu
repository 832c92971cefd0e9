// Kernel K1: fused front-to-back shear-warp compositor, CUDA C++ for sm_90a.
//
// Replaces mri_raytracer_tpu/ops/pallas_composite.py::_make_kernel (launched
// by sweep_composite_pallas, pallas_composite.py:575), with both of its
// overlay sources: K1a, the seg and baked-pred nearest rows, and K1b, the
// mode-2 prediction field (pallas_composite.py:72-89, 124-135, 317-322);
// and with its executed-plane counter, K1c (echo='planes', below). Its
// plain PyTorch version is
// mri_raytracer_tpu_torch/ops/composite.py::composite_planes_plain; the
// arithmetic per (pixel, plane) follows it operation by operation, and
// ops/composite.py::tile_planes_plain mirrors the tile culling below.
//
// Bound on an H100. Bytes: the stage-1 rows, 2 + 1 (+1) bytes per (plane,
// a-row, column), each read once, the field once, three (O, O) maps in and
// 4 floats per pixel out (4 bytes more with the counter): ~158 MB at the
// bench pose (K = 225, Na = 224, O = 896), 0.047 ms at 3.35 TB/s.
// Operations: ~40 fp32 operations and one expf per (pixel, plane) pair that
// composites, 3 more for the nearest label row when a row overlay is on,
// ~14 with one expf per overlay tap whose label is in [1, 8): ~3.3 Gop for
// the 75.1 M pairs of that pose, 0.049 ms at 67 TFLOP/s. Both bounds count
// the pairs that composite, 41.6% of the K x O x O (pixel, plane) slots.
//
// Design: a block owns a kTileI x kTileJ tile of the intermediate image;
// each thread owns kRows vertically adjacent pixels of one column, with the
// grayscale sum, the three label colour sums, T, 'started' (and K1c's
// count) in registers across all planes. Four causes held the previous
// one-thread-per-pixel kernel at 13x its bound; what this one does:
//  1. Every pixel looped over every plane. Here the block first tests each
//     plane against the tile, the Pallas kernel's rule
//     (pallas_composite.py:205-215): the tile's pos_a and pos_b footprints
//     (min and max of its first and last row / column, as sc_a or sc_b may
//     be negative) against the content box, own > 0, and lam >= 0 without
//     a clip. Positions are monotone in i and j under the same rounding as
//     the per-pixel test, so a culled plane holds no pixel that composites.
//     The planes that pass are compacted into a run list in shared memory
//     (a warp ballot per 32 planes) and the loop walks that list only.
//  2. Each plane waited on two dependent bf16 loads. Here the tile's a-row
//     window of each listed plane (the rows its 2-tap lerp and nearest
//     label row can touch, from the same clamps, clipped to [0, Na)) is
//     copied into a ring of kStages stages in shared memory by cp.async in
//     16-byte chunks, kStages - 1 planes ahead of the plane being
//     composited: t1b's TJ columns and the seg / pred rows. Each row is
//     read from device memory once per tile, and the 2 taps and the label
//     are shared-memory reads. K1b's field window (the tile's field rows
//     and columns) goes into a ring of its own, copied only when m / Kf
//     changes. A tap outside [0, Na) reads 0 and is never clamped back.
//     A window taller than kWinRows (|sc_a| > 1: a small O against a large
//     Na) or rows that are not 16-byte aligned (O % 16 != 0) take the
//     direct global-load path: a block-uniform branch per plane, decided in
//     the kernel from the plane table. The field is staged when its rows
//     and the tile's columns are 16-byte aligned (S in {1, 2, 4}, Op % 16
//     == 0), else read directly.
//  3. Warps diverged at the per-thread exit. Here the block leaves the
//     plane loop once every pixel of the tile has T <= 0.01 (the Pallas
//     kernel's 'alive' flag): the vote is the __syncthreads_or that also
//     orders the ring, one barrier per plane. Inside a running tile a pixel
//     with T <= 0.01 skips the plane, as the plain version's act does.
//  4. The counting variant spilled. K1c is still a template flag (below);
//     __launch_bounds__(kThreads, 2) gives each thread up to 128 registers.
// A plane's work on a thread's kRows pixels runs in phases across them
// (which composite, with their taps and labels; the compositing; each
// overlay). The first two are straight-line with selects, so that the
// pixels' chains of shared-memory loads and expf overlap: with the pixels
// one after the other, a warp's plane was kRows dependent chains at 16
// warps per SM. Gamma is a template flag for the same reason: a runtime
// branch around powf would split the phases. A row overlay runs only where
// a pixel has a label; the field's runs straight-line. The per-pixel tests of a listed plane and the
// compositing are those of the plain version: positions rounded with
// __fmul_rn/__fadd_rn (a box edge compared with a fused multiply-add flips
// a mask), expf and powf (no fast math), the entry correction and
// 'started' per pixel; an intensity update of a pixel that does not
// composite is computed and discarded.
// Tensor cores do not help: the Pallas kernel's a-axis product is a dense
// hat matrix doing ~Na/2 times the multiply-adds of the 2-tap lerp.
//
// K1b. The field is (ceil(K / Kf), Op, Op) uint8 with Op = O / S: plane m
// reads row m / Kf at (i / S, j / S), the TPU kernel's floor one-hot
// upsampling along planes, rows and columns, gated by the plane's activity
// only, not by the a-row range check of the row overlays.
//
// K1c. The TPU kernel's echo='planes' counter (pallas_composite.py:111,
// 328-336, 351-353) counted, per (tile_i x O) tile, the planes whose
// compute ran. Here the count is per pixel: the planes whose act test
// passed, i.e. the (pixel, plane) pairs that composited, the work these
// inputs need whatever tiles a compositor uses (the culling and the tile
// exit skip only pairs that do not composite). It is a template flag, as
// the TPU kernel's was static: the launch without a counter compiles
// without it, and the counting launch writes an (O, O) int32 map beside C
// and T.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileI = 16;     // rows i of a tile
constexpr int kTileJ = 64;     // columns j of a tile
constexpr int kThreads = 256;  // a column each, kRows adjacent rows each
constexpr int kRows = kTileI * kTileJ / kThreads;
// a-rows a stage holds: every window of a plane with |sc_a| <= 1.
constexpr int kWinRows = kTileI + 2;
constexpr int kStages = 4;
constexpr int kT1bBytes = kWinRows * kTileJ * 2;
constexpr int kLabBytes = kWinRows * kTileJ;
constexpr int kStageBytes = kT1bBytes + 2 * kLabBytes;  // t1b, seg, pred
constexpr int kFieldBytes = kTileI * kTileJ;  // field rows x columns, S >= 1
constexpr int kRingBytes = kStages * (kStageBytes + kFieldBytes);
constexpr int kHeadBytes = 32 * 4 + 16;  // label LUT, run-list length
// Per plane: its table row padded to 8 floats, its a-row window, its
// run-list slot.
constexpr int kPlaneBytes = 8 * 4 + 8 + 4;
constexpr int kSmemMax = 232448;  // dynamic shared memory of a block, sm_90

static_assert(kRows * kThreads == kTileI * kTileJ, "tile / threads");
static_assert(kThreads % kTileJ == 0, "a thread's pixels share a column");

size_t smem_bytes(int K) {
  return (size_t)kRingBytes + kHeadBytes + (size_t)K * kPlaneBytes;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

template <bool kCount, bool kGamma>
__global__ void __launch_bounds__(kThreads, 2) composite_kernel(
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
    int K, int Na, int O, int S, int Kf, int Op, int use_clip) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                       // kStages x kStageBytes
  unsigned char* fring = smem + kStages * kStageBytes;  // kStages fields
  float* s_lut = reinterpret_cast<float*>(smem + kRingBytes);
  int* s_nrun = reinterpret_cast<int*>(s_lut + 32);
  float* s_pp = reinterpret_cast<float*>(smem + kRingBytes + kHeadBytes);
  int2* s_win = reinterpret_cast<int2*>(s_pp + 8 * K);
  int* s_run = reinterpret_cast<int*>(s_win + K);

  const int tid = threadIdx.x;
  for (int t = tid; t < K * 7; t += kThreads) s_pp[t / 7 * 8 + t % 7] = pp[t];
  if (tid < 32) s_lut[tid] = lut[tid];

  const float ww = sc[0], wl = sc[1], gamma = sc[2], ia = sc[3];
  const float near_t = sc[4], far_t = sc[5];
  const float show_seg = sc[6], show_pred = sc[7];
  const float mask_b_lo = sc[8], mask_b_hi = sc[9];
  const float a_clamp_lo = sc[10], a_clamp_hi = sc[11];
  const float a_clamp_hi_n = sc[12];
  const float mask_a_lo = sc[13], mask_a_hi = sc[14];
  const float lo = wl - 0.5f * ww;
  const float inv_ww = 1.0f / ww;
  const bool has_rows = seg_rows != nullptr || pred_rows != nullptr;

  // The tile: rows [i0, i1], columns [j0, j1], clipped to the image.
  const int i0 = blockIdx.y * kTileI, j0 = blockIdx.x * kTileJ;
  const int i1 = min(i0 + kTileI, O) - 1, j1 = min(j0 + kTileJ, O) - 1;
  __syncthreads();

  // ---- Per plane: can any pixel of the tile composite it (the culling
  // rule), and the a-rows its taps and nearest label rows can read.
  for (int m = tid; m < K; m += kThreads) {
    const float* q = s_pp + 8 * m;
    const float off_a = q[0], sc_a = q[1], off_b = q[2], sc_b = q[3];
    const float lam = q[4], own = q[5];
    const float pa0 = __fadd_rn(off_a, __fmul_rn((float)i0, sc_a));
    const float pa1 = __fadd_rn(off_a, __fmul_rn((float)i1, sc_a));
    const float pb0 = __fadd_rn(off_b, __fmul_rn((float)j0, sc_b));
    const float pb1 = __fadd_rn(off_b, __fmul_rn((float)j1, sc_b));
    const float a_min = fminf(pa0, pa1), a_max = fmaxf(pa0, pa1);
    bool ok = a_max >= mask_a_lo && a_min <= mask_a_hi &&
              fmaxf(pb0, pb1) >= mask_b_lo && fminf(pb0, pb1) <= mask_b_hi &&
              own > 0.f;
    if (!use_clip) ok = ok && lam >= 0.f;
    int w_lo = (int)floorf(fminf(fmaxf(a_min, a_clamp_lo), a_clamp_hi));
    int w_hi = (int)floorf(fminf(fmaxf(a_max, a_clamp_lo), a_clamp_hi)) + 1;
    if (has_rows) {
      w_lo = min(w_lo,
                 (int)rintf(fminf(fmaxf(a_min, a_clamp_lo), a_clamp_hi_n)));
      w_hi = max(w_hi,
                 (int)rintf(fminf(fmaxf(a_max, a_clamp_lo), a_clamp_hi_n)));
    }
    s_win[m] = make_int2(max(w_lo, 0), min(w_hi, Na - 1));
    s_run[m] = ok;
  }
  __syncthreads();
  // Compact the planes that pass into the run list, in order, in place:
  // chunk c writes slots below 32 (c + 1), whose flags are already read.
  if (tid < 32) {
    int n = 0;
    for (int c = 0; c < K; c += 32) {
      const int m = c + tid;
      const bool ok = m < K && s_run[m] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      __syncwarp();
      if (ok) s_run[n + __popc(bal & ((1u << tid) - 1u))] = m;
      n += __popc(bal);
      __syncwarp();
    }
    if (tid == 0) *s_nrun = n;
  }

  // ---- This thread's pixels: column j, rows ib .. ib + kRows - 1.
  const int jl = tid % kTileJ;
  const int j = j0 + jl;
  const int ib = i0 + tid / kTileJ * kRows;
  const float fj = (float)j;
  const size_t plane = (size_t)Na * O;
  float dt[kRows], r[kRows], vm[kRows];
  float cg[kRows], lr[kRows], lg[kRows], lb[kRows], T[kRows];
  bool started[kRows];
  int n_planes[kRows];  // K1c: planes that composited
  int foff[kRows];      // K1b: the pixel's tap in its field window or row
  // Rows 16-byte aligned for cp.async: else every plane loads directly.
  const bool rows_staged =
      (O & 15) == 0 && aligned16(t1b) &&
      (seg_rows == nullptr || aligned16(seg_rows)) &&
      (pred_rows == nullptr || aligned16(pred_rows));
  const bool field_staged = field != nullptr && aligned16(field) &&
                            (Op & 15) == 0 && kTileJ % S == 0 &&
                            (kTileJ / S) % 16 == 0;
  const int fr0 = i0 / S, fc0 = j0 / S;
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    const int i = ib + p;
    const bool valid = i < O && j < O;
    const size_t pix = (size_t)i * O + j;
    dt[p] = valid ? dt_map[pix] : 0.f;
    r[p] = valid ? r_map[pix] : 0.f;
    vm[p] = valid ? vmag[pix] : 0.f;
    cg[p] = lr[p] = lg[p] = lb[p] = 0.f;
    T[p] = valid ? 1.f : 0.f;  // a pixel off the image never runs
    started[p] = false;
    n_planes[p] = 0;
    foff[p] = field_staged ? (i / S - fr0) * kTileJ + (j / S - fc0)
                           : (i / S) * Op + j / S;
  }
  __syncthreads();
  const int n_run = *s_nrun;

  // ---- Producer: stage run-list entry n into ring slot n % kStages (and
  // its field window when m / Kf changes), then commit one group, empty or
  // not, so that group n is always plane n's.
  int p_mf = -1, p_k = -1;  // producer's last field row and field slots
  auto issue = [&](int n) {
    if (n < n_run) {
      const int m = s_run[n];
      const int2 w = s_win[m];
      if (rows_staged && w.y - w.x < kWinRows) {
        unsigned char* st = ring + (n % kStages) * kStageBytes;
        const int h = w.y - w.x + 1;  // <= 0: every tap is out of range
        const size_t row0 = (size_t)m * plane + (size_t)w.x * O + j0;
        for (int c = tid; c < h * 8; c += kThreads) {  // 8 chunks a row
          const int k = c & 7;
          if (j0 + 8 * k < O)
            cp_async16(st + (c >> 3) * (kTileJ * 2) + 16 * k,
                       t1b + row0 + (size_t)(c >> 3) * O + 8 * k);
        }
        for (int c = tid; c < h * 4; c += kThreads) {  // 4 chunks a row
          const int k = c & 3;
          if (j0 + 16 * k >= O) continue;
          const size_t g = row0 + (size_t)(c >> 2) * O + 16 * k;
          const int s = kT1bBytes + (c >> 2) * kTileJ + 16 * k;
          if (seg_rows != nullptr) cp_async16(st + s, seg_rows + g);
          if (pred_rows != nullptr) cp_async16(st + s + kLabBytes, pred_rows + g);
        }
      }
      if (field_staged && m / Kf != p_mf) {
        p_mf = m / Kf;
        ++p_k;
        unsigned char* fs = fring + (p_k % kStages) * kFieldBytes;
        const int nch = (j1 / S - fc0) / 16 + 1;  // 16-byte chunks a row
        const int nr = i1 / S - fr0 + 1;
        for (int c = tid; c < nr * nch; c += kThreads) {
          const int row = c / nch, k = c % nch;
          cp_async16(fs + row * kTileJ + 16 * k,
                     field + ((size_t)p_mf * Op + fr0 + row) * Op + fc0 +
                         16 * k);
        }
      }
    }
    cp_async_commit();
  };

  for (int n = 0; n < kStages - 1; ++n) issue(n);
  int c_mf = -1, c_k = -1;  // consumer's last field row and field slots
  for (int n = 0; n < n_run; ++n) {
    cp_async_wait<kStages - 2>();  // this thread's copies of plane n
    bool alive = false;
#pragma unroll
    for (int p = 0; p < kRows; ++p) alive = alive || T[p] > 0.01f;
    // Every thread's copies of plane n have landed, every thread is done
    // with plane n - 1's slot, and the tile leaves once no ray is alive.
    if (!__syncthreads_or(alive)) break;
    issue(n + kStages - 1);

    const int m = s_run[n];
    const int2 w = s_win[m];
    const unsigned char* st = ring + (n % kStages) * kStageBytes;
    const uint8_t* frow = nullptr;  // the field tap of pixel p: frow[foff[p]]
    if (field != nullptr) {
      if (field_staged) {
        if (m / Kf != c_mf) {
          c_mf = m / Kf;
          ++c_k;
        }
        frow = fring + (c_k % kStages) * kFieldBytes;
      } else {
        frow = field + (size_t)(m / Kf) * Op * Op;
      }
    }
    const float4 q0 = *reinterpret_cast<const float4*>(s_pp + 8 * m);
    const float4 q1 = *reinterpret_cast<const float4*>(s_pp + 8 * m + 4);
    const float off_a = q0.x, sc_a = q0.y, off_b = q0.z, sc_b = q0.w;
    const float lam = q1.x, own = q1.y, q_m = q1.z;
    // Rounded as the plain version rounds them (no fused multiply-add):
    // the box masks compare these positions with the box edges exactly, and
    // a field label on an edge pixel shows whether that plane counted.
    const float pos_b = __fadd_rn(off_b, __fmul_rn(fj, sc_b));
    bool col_act = pos_b >= mask_b_lo && pos_b <= mask_b_hi && own > 0.f;
    if (!use_clip) col_act = col_act && lam >= 0.f;  // planes behind the eye
    if (!col_act) continue;

    // The plane's work on this thread's kRows pixels, in phases across the
    // pixels so that their independent chains (loads, expf) overlap: which
    // pixels composite, their taps and labels, then the compositing, each
    // update of a pixel that does not composite discarded by a select.
    auto composite = [&](auto staged_tag) {
      constexpr bool kStaged = decltype(staged_tag)::value;
      bool act[kRows];
      float g[kRows], v[kRows], dt_e[kRows];
      int lab_seg[kRows], lab_pred[kRows];
      bool any = false;
#pragma unroll
      for (int p = 0; p < kRows; ++p) {
        const float pos_a = __fadd_rn(off_a, __fmul_rn((float)(ib + p), sc_a));
        bool a = T[p] > 0.01f && pos_a >= mask_a_lo && pos_a <= mask_a_hi;
        if (use_clip) {
          const float t_k = lam * vm[p];
          a = a && t_k >= near_t && t_k <= far_t;
        }
        // Pre-entry gate; r >= 1e37 is the "no entry correction" sentinel.
        g[p] = q_m - r[p];
        act[p] = a && (g[p] >= -1e-3f || r[p] >= 1e37f);
        any = any || act[p];
        if (kCount) n_planes[p] += act[p];

        // a-axis lerp of the stage-1 rows; an absent tap reads 0.
        const float qa = fminf(fmaxf(pos_a, a_clamp_lo), a_clamp_hi);
        const float a0f = floorf(qa);
        const float fa = qa - a0f;
        const int a0 = (int)a0f;
        const bool in0 = act[p] && a0 >= 0 && a0 < Na;
        const bool in1 = act[p] && a0 + 1 >= 0 && a0 + 1 < Na;
        float x0, x1;
        if (kStaged) {
          const __nv_bfloat16* col =
              reinterpret_cast<const __nv_bfloat16*>(st) + jl;
          x0 = in0 ? __bfloat162float(col[(a0 - w.x) * kTileJ]) : 0.f;
          x1 = in1 ? __bfloat162float(col[(a0 + 1 - w.x) * kTileJ]) : 0.f;
        } else {
          const __nv_bfloat16* col = t1b + (size_t)m * plane + j;
          x0 = in0 ? __bfloat162float(col[(size_t)a0 * O]) : 0.f;
          x1 = in1 ? __bfloat162float(col[(size_t)(a0 + 1) * O]) : 0.f;
        }
        v[p] = (1.f - fa) * x0 + fa * x1;

        // Label rows: the nearest a-row; label 0 is transparent.
        lab_seg[p] = lab_pred[p] = 0;
        const int an =
            (int)rintf(fminf(fmaxf(pos_a, a_clamp_lo), a_clamp_hi_n));
        const bool inn = act[p] && has_rows && an >= 0 && an < Na;
        if (kStaged) {
          const unsigned char* lab = st + kT1bBytes + (an - w.x) * kTileJ + jl;
          if (seg_rows != nullptr && inn) lab_seg[p] = lab[0];
          if (pred_rows != nullptr && inn) lab_pred[p] = lab[kLabBytes];
        } else {
          const size_t off = (size_t)m * plane + (size_t)an * O + j;
          if (seg_rows != nullptr && inn) lab_seg[p] = seg_rows[off];
          if (pred_rows != nullptr && inn) lab_pred[p] = pred_rows[off];
        }
        if (frow != nullptr && act[p]) lab_pred[p] = frow[foff[p]];
      }
      if (!any) return;

#pragma unroll
      for (int p = 0; p < kRows; ++p) {
        // The ray's first active plane extends its dt by the entry->crossing
        // distance g (clipped to [0, 2]; g >= 2 means no correction).
        const float corr = g[p] < 2.f ? fminf(fmaxf(g[p], 0.f), 2.f) : 0.f;
        dt_e[p] = dt[p] * (1.f + corr * (started[p] ? 0.f : 1.f));
        float val = fminf(fmaxf((v[p] - lo) * inv_ww, 0.f), 1.f);
        if (kGamma) val = powf(val, gamma);
        const float aI = 1.f - expf(-val * ia * dt_e[p]);
        const float cg_n = cg[p] + aI * T[p] * val;
        const float T_n = T[p] * (1.f - aI);
        if (act[p]) {
          cg[p] = cg_n;
          T[p] = T_n;
          started[p] = true;
        }
      }

      // Label LUT overlays, in the TPU kernel's order: seg at 1x opacity,
      // then pred at 1.5x from its baked rows or from the field. Label 0
      // (and anything outside [1, 8)) is transparent and changes nothing.
      // Row labels are rare (3.4 M seg taps of 75.1 M pairs at the bench
      // pose): a pixel without one skips its overlay, so a warp with no
      // labelled lane does no overlay work. The field labels nearly every
      // pixel (kDense): its overlay runs straight-line with selects, so
      // that the pixels' expf chains overlap.
      auto overlay = [&](const int (&labs)[kRows], float rate, float show,
                         auto dense_tag) {
        constexpr bool kDense = decltype(dense_tag)::value;
#pragma unroll
        for (int p = 0; p < kRows; ++p) {
          const bool on = act[p] && labs[p] > 0 && labs[p] < 8;
          if (!kDense && !on) continue;
          const float4 c =
              reinterpret_cast<const float4*>(s_lut)[on ? labs[p] : 0];
          const float aS = (1.f - expf(-c.w * dt_e[p] * rate)) * show;
          const float wt = aS * T[p];
          const float lr_n = lr[p] + wt * c.x, lg_n = lg[p] + wt * c.y;
          const float lb_n = lb[p] + wt * c.z, T_n = T[p] * (1.f - aS);
          if (on) {
            lr[p] = lr_n;
            lg[p] = lg_n;
            lb[p] = lb_n;
            T[p] = T_n;
          }
        }
      };
      if (seg_rows != nullptr)
        overlay(lab_seg, 1.f, show_seg, std::false_type{});
      if (pred_rows != nullptr)
        overlay(lab_pred, 1.5f, show_pred, std::false_type{});
      if (frow != nullptr) overlay(lab_pred, 1.5f, show_pred, std::true_type{});
    };
    // A window over the stage's capacity (or unaligned rows): direct loads.
    if (rows_staged && w.y - w.x < kWinRows)
      composite(std::true_type{});
    else
      composite(std::false_type{});
  }
  cp_async_wait<0>();

#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    const int i = ib + p;
    if (i >= O || j >= O) continue;
    const size_t pix = (size_t)i * O + j;
    C[pix * 3 + 0] = cg[p] + lr[p];
    C[pix * 3 + 1] = cg[p] + lg[p];
    C[pix * 3 + 2] = cg[p] + lb[p];
    T_out[pix] = T[p];
    if (kCount) planes[pix] = n_planes[p];
  }
}

using Kernel = decltype(&composite_kernel<false, false>);

// The instantiation for a launch: with the counter (K1c) or not, with
// the gamma pow or not. `v` indexes the four as 2 * count + gamma.
Kernel kernel_of(int v) {
  switch (v) {
    case 0: return composite_kernel<false, false>;
    case 1: return composite_kernel<false, true>;
    case 2: return composite_kernel<true, false>;
    default: return composite_kernel<true, true>;
  }
}

// Lets instantiation `v` use `smem` bytes of dynamic shared memory; raises
// its limit once, when it first needs more than the default 48 KB.
int allow_smem(int v, size_t smem) {
  static size_t allowed[4] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024};
  if (smem <= allowed[v]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_of(v), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed[v] = smem;
  return (int)err;
}

}  // namespace

// Launches K1 on `stream`; returns a cudaError_t (0 on success).
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
  const size_t smem = smem_bytes(K);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const int v = 2 * (planes != nullptr) + (use_gamma != 0);
  const int err = allow_smem(v, smem);
  if (err != 0) return err;
  const dim3 grid((O + kTileJ - 1) / kTileJ, (O + kTileI - 1) / kTileI);
  kernel_of(v)<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)t1b, (const uint8_t*)seg_rows,
      (const uint8_t*)pred_rows, (const uint8_t*)field, (const float*)pp,
      (const float*)sc, (const float*)lut, (const float*)vmag,
      (const float*)dt_map, (const float*)r_map, (float*)C, (float*)T,
      (int32_t*)planes, K, Na, O, field != nullptr ? S : 1,
      field != nullptr ? Kf : 1, field != nullptr ? Op : 0, use_clip);
  return (int)cudaGetLastError();
}

// What the kernel is, for a launch of K planes: out[0..6] = kTileI, kTileJ,
// kThreads, kWinRows, kStages, dynamic shared memory bytes, the most it may
// have; then for each instantiation v = 2 * count + gamma (v = 0 is the
// production launch, 2 K1c's): resident blocks per SM, registers per
// thread, local (stack and spilled) bytes per thread, at out[7 + 3 * v].
// Returns a cudaError_t (0 on success).
extern "C" int mrt_composite_info(int K, int* out) {
  const size_t smem = smem_bytes(K);
  out[0] = kTileI;
  out[1] = kTileJ;
  out[2] = kThreads;
  out[3] = kWinRows;
  out[4] = kStages;
  out[5] = (int)smem;
  out[6] = kSmemMax;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  for (int v = 0; v < 4; ++v) {
    int err = allow_smem(v, smem);
    if (err != 0) return err;
    const void* fn = (const void*)kernel_of(v);
    int blocks = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                             kThreads, smem);
    if (err != 0) return err;
    cudaFuncAttributes attr;
    err = (int)cudaFuncGetAttributes(&attr, fn);
    if (err != 0) return err;
    out[7 + 3 * v] = blocks;
    out[8 + 3 * v] = attr.numRegs;
    out[9 + 3 * v] = (int)attr.localSizeBytes;
  }
  return 0;
}
