// Kernel K3: the live INR's separable MLP over a block of sweep planes, one
// launch from the sampled intensities to the int32 labels, CUDA C++ for
// sm_90a with bf16 tensor cores (mma.sync).
//
// Replaces no TPU kernel: the JAX package leaves this MLP to XLA
// (mri_raytracer_tpu/ops/neural_march.py, predict_field's block_fn and
// bake_labels). It was added because in the live-INR viewer the MLP held
// ~88% of the device time of a frame as ~62 eager PyTorch operations a
// block, each writing or reading the (points, hidden) float32 states in
// device memory and the products on the float32 SIMT units. Its plain
// version is mri_raytracer_tpu_torch/ops/neural_march.py::
// separable_logits_plain (+ argmax), whose arithmetic it follows.
//
// What it computes, per point (b, i, j) of B planes x Oa rows x Ob columns:
//   h1 = relu(((row_i + col_j) + const) + bf16(x) . bf16(W1_int)), float32,
//        rounded to bf16, where row_i, col_j and const are the first layer's
//        coordinate terms: the Fourier features [t | sin(t k pi) | cos(t k
//        pi)] of the row's, the column's and the plane's normalized
//        coordinate times W1's float32 rows of the coordinate each feeds
//        (const also adds the bias); x the point's M intensities;
//   h_{l+1} = bf16(relu(b_l + h_l W_l)), bf16 operands, float32 sums;
//   label = argmax(b_L + h_L W_L) over the C classes, the first maximum.
//
// Bound on an H100, at the live-INR viewer's block (B = 16, Oa = Ob = 256,
// M = 4, hidden 64 x 4, 6 harmonics, 4 classes: 1,048,576 points).
// Operations: 2 x (M H + 3 H^2 + H C) = 25.6 kFLOP a point on the bf16
// tensor cores (989 TFLOP/s): 0.027 ms a block. Bytes: the intensities read
// once (16 B a point) and the label written once (4 B): 21 MB, 0.0063 ms at
// 3.35 TB/s. So the tensor cores bound it, and only if the hidden states
// never reach device memory.
//
// Design.
//  - A block of kWarps warps walks tiles of TI rows x kTileJ columns of one
//    plane (a grid of as many blocks as fit on the card at once). Per tile
//    it builds the first layer's terms in shared memory: the features of the
//    tile's TI row coordinates, kTileJ column coordinates and its plane's
//    coordinate (sinf / cosf, no fast math, k pi rounded to float32 as the
//    plain version rounds it), then their products with W1's rows (TI +
//    kTileJ + 1) x H1 values; each is shared by kTileJ or TI points.
//  - A warp takes MT m16 tiles of points (MT x 16 consecutive columns of one
//    row): 32 points at widths up to 128, so each B fragment read from
//    shared memory feeds two mma.sync; 16 at wider layers, whose
//    activations would not fit twice in a thread's registers otherwise.
//    Each thread computes its A fragments of the first hidden state from
//    the terms, in the plain version's order of additions, with relu and
//    the bf16 rounding in registers.
//  - Each dense layer is mma.sync.m16n8k16 (bf16 operands, float32
//    accumulators seeded with the bias), taken 16 output columns at a time:
//    the two m16n8 C fragments of a column pair, after relu and the bf16
//    rounding, are exactly the next layer's m16k16 A fragment, so the
//    activations never leave registers. B fragments are read by ldmatrix
//    from W^T in shared memory (bf16, rows padded by 8 elements: 16-byte
//    aligned, and the 8 rows of an 8 x 8 matrix fall in 8 distinct 16-byte
//    bank groups).
//  - The weights are the model's float32 tensors: each block converts them
//    to bf16 as it copies them into shared memory, so nothing is packed on
//    the host and a new set of weights needs nothing but the next launch.
//    When all hidden layers fit in shared memory together (every width up
//    to 128 at the reference's four layers) they are loaded once per block;
//    otherwise (width 256) they pass through one slot, one layer at a time,
//    the block's warps in step.
//  - The head (C <= 8 classes, N padded to 8) runs the same way; the argmax
//    reduces over each quad of lanes by shuffles and the label is stored as
//    int32 into the caller's (B, Oa, Ob) output.
//  - The hidden widths are read at run time (each a multiple of 16, up to
//    256, not all equal if need be); the instantiation is picked by the
//    widest: its register arrays and unrolled loops span that width, the
//    loops skip the chunks a narrower layer lacks.
// Intensities are read in place through their four strides (the resample's
// (M, B, Op, Op) buffer seen as (B, Op, Op, M)); a point past the plane's
// last row or column is computed from clamped inputs and not stored.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileJ = 32;      // columns of a tile
constexpr int kMaxLayers = 16;  // dense layers, the first and the head too
constexpr int kMaxM = 4;        // intensities a point
constexpr int kMaxC = 8;        // classes: one n8 tile
constexpr int kPad = 8;         // bf16 elements after each row of W^T
constexpr int kTermPad = 8;     // floats after each row of the terms
constexpr float kPi = 3.14159265358979323846f;

struct Net {
  const float* W[kMaxLayers];  // (in, out) row-major, float32
  const float* b[kMaxLayers];  // (out,)
  int width[kMaxLayers + 1];   // width[0] the first layer's fan-in
  int n_layers;
};

struct Problem {
  const float* x;  // intensities, element (b, i, j, m) at b sb + i si + ...
  long long sb, si, sj, sm;
  const float* a_n;  // (B, Oa) row coordinates
  const float* b_n;  // (B, Ob) column coordinates
  const float* k_n;  // (B,) plane coordinates
  int* out;          // (B, Oa, Ob) labels
  int B, Oa, Ob, M, K;
  int c_k, c_a, c_b;  // the coordinate (x, y, z = 0, 1, 2) each feeds
  int tiles_i, tiles_j, tiles;
  int resident;  // 1: every hidden layer's W^T in shared memory at once
  // Byte offsets in dynamic shared memory; off_w[l] for l in [1, L - 1).
  int off_w[kMaxLayers];
  int off_head, off_bias, off_w1i, off_terms, off_feat;
  int boff[kMaxLayers];  // layer l's bias at float offset boff[l]
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// c += a (m16 x k16, row) * b (k16 x n8, col), bf16 operands, f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float relu(float v) { return v > 0.f ? v : 0.f; }

// dst[n][k] = bf16(W[k][n]) for n < out, 0 for out <= n < rows; rows of
// in + kPad elements. Two k a thread, so each store is 4 bytes. kFast, for
// a layer that streams through shared memory (width 256: loaded many times
// a tile, where one float at a time the load waits on the L2's latency):
// where W's rows allow it, four n a thread read as two float4s, four such
// items in flight a thread. The once-a-block loads take the plain loop,
// whose registers the narrow instantiation cannot spare.
template <bool kFast>
__device__ void load_wt(__nv_bfloat16* dst, const float* __restrict__ W,
                        int in, int out, int rows) {
  const int stride = in + kPad;
  if (kFast && rows == out && out % 4 == 0 &&
      reinterpret_cast<std::uintptr_t>(W) % 16 == 0) {
    const int groups = out >> 2, items = (in >> 1) * groups;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < items; idx += kThreads) {
      const int k2 = idx / groups, n = (idx - k2 * groups) << 2;
      const float4 r0 =
          __ldg(reinterpret_cast<const float4*>(W + (size_t)(2 * k2) * out + n));
      const float4 r1 = __ldg(
          reinterpret_cast<const float4*>(W + (size_t)(2 * k2 + 1) * out + n));
      __nv_bfloat16* d = dst + n * stride + 2 * k2;
      *reinterpret_cast<uint32_t*>(d) = pack_bf16(r0.x, r1.x);
      *reinterpret_cast<uint32_t*>(d + stride) = pack_bf16(r0.y, r1.y);
      *reinterpret_cast<uint32_t*>(d + 2 * stride) = pack_bf16(r0.z, r1.z);
      *reinterpret_cast<uint32_t*>(d + 3 * stride) = pack_bf16(r0.w, r1.w);
    }
    return;
  }
  const int pairs = (in >> 1) * rows;
  for (int idx = threadIdx.x; idx < pairs; idx += kThreads) {
    const int k2 = idx / rows, n = idx - k2 * rows;
    uint32_t v = 0;
    if (n < out)
      v = pack_bf16(__ldg(W + (size_t)(2 * k2) * out + n),
                    __ldg(W + (size_t)(2 * k2 + 1) * out + n));
    *reinterpret_cast<uint32_t*>(dst + n * stride + 2 * k2) = v;
  }
}

// One dense layer + relu + bf16 on a warp's A fragments, in place.
template <int NK, int MT>
__device__ __forceinline__ void dense_relu(uint32_t (&a)[NK][MT][4],
                                           const __nv_bfloat16* wt, int in,
                                           int out, const float* bias,
                                           int lane) {
  const int nk_in = in >> 4, nk_out = out >> 4, stride = in + kPad;
  const int t = lane & 3;
  const int ln = (lane & 7) + ((lane >> 4) << 3), lk = ((lane >> 3) & 1) << 3;
  uint32_t o[NK][MT][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if (j < nk_out) {
      float acc[MT][2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 bv =
            *reinterpret_cast<const float2*>(bias + 16 * j + 8 * h + 2 * t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][h][0] = bv.x;
          acc[mt][h][1] = bv.y;
          acc[mt][h][2] = bv.x;
          acc[mt][h][3] = bv.y;
        }
      }
      const __nv_bfloat16* wrow = wt + (16 * j + ln) * stride + lk;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        if (k < nk_in) {
          uint32_t bf[4];
          ldmatrix_x4(bf, wrow + 16 * k);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(acc[mt][0], a[k][mt], bf[0], bf[1]);
            mma(acc[mt][1], a[k][mt], bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        o[j][mt][0] = pack_bf16(relu(acc[mt][0][0]), relu(acc[mt][0][1]));
        o[j][mt][1] = pack_bf16(relu(acc[mt][0][2]), relu(acc[mt][0][3]));
        o[j][mt][2] = pack_bf16(relu(acc[mt][1][0]), relu(acc[mt][1][1]));
        o[j][mt][3] = pack_bf16(relu(acc[mt][1][2]), relu(acc[mt][1][3]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[j][mt][r] = o[j][mt][r];
}

// (value, class) a beats (value, class) b under torch.argmax: NaN above
// every number, and the first class among equals. kNone is no candidate.
constexpr int kNone = 1 << 20;

__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  if (ia == kNone) return false;
  if (ib == kNone) return true;
  const bool na = va != va, nb = vb != vb;
  if (na || nb) return na && (!nb || ia < ib);
  return va > vb || (va == vb && ia < ib);
}

// Minimum resident blocks an SM for __launch_bounds__: caps registers at
// 168 a thread for the narrow instantiation (it uses ~134; capped at 128,
// for 4 blocks, it spills), 255 for the others. The narrow one never streams its weights: kMaxLayers layers of
// width 64 fit in shared memory together, so its hot loop carries no
// streaming load.
template <int NK>
struct Traits {
  static constexpr int kMinBlocks = NK <= 4 ? 3 : 1;
  static constexpr bool kStreams = NK > 4;
};

template <int NK, int MT, int TI>
__global__ void __launch_bounds__(kThreads, Traits<NK>::kMinBlocks)
    inr_mlp_kernel(const Net net, const Problem pb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int L = net.n_layers;
  const int H1 = net.width[1], C = net.width[L];
  const int K = pb.K, E = 1 + 2 * K, M = pb.M;
  const int TS = H1 + kTermPad;
  float* bias = reinterpret_cast<float*>(smem + pb.off_bias);
  float* w1i = reinterpret_cast<float*>(smem + pb.off_w1i);
  __nv_bfloat16* head = reinterpret_cast<__nv_bfloat16*>(smem + pb.off_head);
  float* rowT = reinterpret_cast<float*>(smem + pb.off_terms);
  float* colT = rowT + TI * TS;
  float* constT = colT + kTileJ * TS;
  float* feat = reinterpret_cast<float*>(smem + pb.off_feat);
  const float* __restrict__ W0 = net.W[0];

  // Once a block: the later layers' biases (the head's padded to kMaxC),
  // W1's intensity rows rounded to bf16, the head's W^T, and the hidden
  // layers' W^T when they all fit.
  for (int l = 1; l < L; ++l) {
    const int n = net.width[l + 1], rows = l == L - 1 ? kMaxC : n;
    for (int x = tid; x < rows; x += kThreads)
      bias[pb.boff[l] + x] = x < n ? net.b[l][x] : 0.f;
  }
  const int r_int = net.width[0] - M;
  for (int x = tid; x < M * H1; x += kThreads)
    w1i[x] = round_bf16(__ldg(W0 + (size_t)r_int * H1 + x));
  load_wt<false>(head, net.W[L - 1], net.width[L - 1], C, kMaxC);
  if (pb.resident)
    for (int l = 1; l < L - 1; ++l)
      load_wt<false>(reinterpret_cast<__nv_bfloat16*>(smem + pb.off_w[l]),
                     net.W[l], net.width[l], net.width[l + 1],
                     net.width[l + 1]);

  constexpr int kSegs = kTileJ / (16 * MT);  // warp units a tile row
  constexpr int kUnits = TI * kSegs;
  const int NR = TI + kTileJ + 1;  // term rows: TI rows, kTileJ columns, 1
  const int per_plane = pb.tiles_i * pb.tiles_j;
  for (int tile = blockIdx.x; tile < pb.tiles; tile += gridDim.x) {
    const int b = tile / per_plane;
    const int ti = (tile - b * per_plane) / pb.tiles_j;
    const int tj = tile - b * per_plane - ti * pb.tiles_j;
    const int i0 = ti * TI, j0 = tj * kTileJ;
    __syncthreads();  // the last tile's terms are read; weights are loaded

    // Features of the tile's coordinates (plain version: _axis_feat).
    for (int x = tid; x < NR * E; x += kThreads) {
      const int r = x / E, e = x - r * E;
      float c;
      if (r < TI)
        c = pb.a_n[(size_t)b * pb.Oa + min(i0 + r, pb.Oa - 1)];
      else if (r < TI + kTileJ)
        c = pb.b_n[(size_t)b * pb.Ob + min(j0 + r - TI, pb.Ob - 1)];
      else
        c = pb.k_n[b];
      float v = c;
      if (e > 0) {
        const int q = e <= K ? e : e - K;  // harmonic 1..K
        const float ang = c * (static_cast<float>(q) * kPi);
        v = e <= K ? sinf(ang) : cosf(ang);
      }
      feat[x] = v;
    }
    __syncthreads();
    // Terms (plain version: _separable_first_layer_batched): the features
    // times W1's rows of the coordinate they feed; the plane's adds b1.
    for (int x = tid; x < NR * H1; x += kThreads) {
      const int r = x / H1, f = x - r * H1;
      const int c = r < TI ? pb.c_a : (r < TI + kTileJ ? pb.c_b : pb.c_k);
      const float* fr = feat + r * E;
      float s = fr[0] * __ldg(W0 + (size_t)c * H1 + f);
      for (int e = 1; e < E; ++e)
        s = fmaf(fr[e], __ldg(W0 + (size_t)(3 + 2 * K * c + e - 1) * H1 + f),
                 s);
      if (r < TI)
        rowT[r * TS + f] = s;
      else if (r < TI + kTileJ)
        colT[(r - TI) * TS + f] = s;
      else
        constT[f] = __ldg(net.b[0] + f) + s;
    }
    __syncthreads();

    for (int u0 = 0; u0 < kUnits; u0 += kWarps) {
      const int u = u0 + warp;
      const int rr = u / kSegs, jl = (u - rr * kSegs) * 16 * MT;
      const int i = i0 + rr;
      const bool active = u < kUnits && i < pb.Oa;  // uniform in the warp
      uint32_t a[NK][MT][4];
      if (active) {
        // The thread's points: rows g and g + 8 of each m16 tile.
        float xv[MT][2][kMaxM];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = min(j0 + jl + 16 * mt + 8 * h + g, pb.Ob - 1);
            const float* p = pb.x + b * pb.sb + i * pb.si + j * pb.sj;
#pragma unroll
            for (int m = 0; m < kMaxM; ++m)
              xv[mt][h][m] = m < M ? round_bf16(__ldg(p + m * pb.sm)) : 0.f;
          }
        const float* rowp = rowT + rr * TS;
        const int nk1 = H1 >> 4;
#pragma unroll
        for (int kc = 0; kc < NK; ++kc) {
          if (kc < nk1) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int f = 16 * kc + 8 * q + 2 * t;
              const float2 rw = *reinterpret_cast<const float2*>(rowp + f);
              const float2 cs = *reinterpret_cast<const float2*>(constT + f);
              float2 w[kMaxM];
#pragma unroll
              for (int m = 0; m < kMaxM; ++m)
                if (m < M)
                  w[m] = *reinterpret_cast<const float2*>(w1i + m * H1 + f);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int cl = jl + 16 * mt + 8 * h + g;
                  const float2 cv =
                      *reinterpret_cast<const float2*>(colT + cl * TS + f);
                  float d0 = xv[mt][h][0] * w[0].x;
                  float d1 = xv[mt][h][0] * w[0].y;
#pragma unroll
                  for (int m = 1; m < kMaxM; ++m)
                    if (m < M) {
                      d0 = fmaf(xv[mt][h][m], w[m].x, d0);
                      d1 = fmaf(xv[mt][h][m], w[m].y, d1);
                    }
                  const float v0 = ((rw.x + cv.x) + cs.x) + d0;
                  const float v1 = ((rw.y + cv.y) + cs.y) + d1;
                  a[kc][mt][h + 2 * q] = pack_bf16(relu(v0), relu(v1));
                }
            }
          }
        }
      }
      for (int l = 1; l < L - 1; ++l) {
        if (Traits<NK>::kStreams && !pb.resident) {
          __syncthreads();  // every warp is done with the slot's last layer
          load_wt<true>(reinterpret_cast<__nv_bfloat16*>(smem + pb.off_w[l]),
                        net.W[l], net.width[l], net.width[l + 1],
                        net.width[l + 1]);
          __syncthreads();
        }
        if (active)
          dense_relu<NK, MT>(
              a, reinterpret_cast<const __nv_bfloat16*>(smem + pb.off_w[l]),
              net.width[l], net.width[l + 1], bias + pb.boff[l], lane);
      }
      if (active) {
        // Head and argmax.
        const int in = net.width[L - 1], nk_in = in >> 4;
        const float2 bv =
            *reinterpret_cast<const float2*>(bias + pb.boff[L - 1] + 2 * t);
        float acc[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][0] = bv.x;
          acc[mt][1] = bv.y;
          acc[mt][2] = bv.x;
          acc[mt][3] = bv.y;
        }
        const __nv_bfloat16* wrow =
            head + (lane & 7) * (in + kPad) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          if (k < nk_in) {
            uint32_t bf[2];
            ldmatrix_x2(bf, wrow + 16 * k);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma(acc[mt], a[k][mt], bf[0], bf[1]);
          }
        }
        int* orow = pb.out + ((size_t)b * pb.Oa + i) * pb.Ob;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = acc[mt][2 * h];
            int c = 2 * t < C ? 2 * t : kNone;
            if (2 * t + 1 < C && beats(acc[mt][2 * h + 1], 2 * t + 1, v, c)) {
              v = acc[mt][2 * h + 1];
              c = 2 * t + 1;
            }
#pragma unroll
            for (int s = 1; s <= 2; s <<= 1) {
              const float vo = __shfl_xor_sync(0xffffffffu, v, s);
              const int co = __shfl_xor_sync(0xffffffffu, c, s);
              if (beats(vo, co, v, c)) {
                v = vo;
                c = co;
              }
            }
            const int j = j0 + jl + 16 * mt + 8 * h + g;
            if (t == h && j < pb.Ob) orow[j] = c;
          }
      }
    }
  }
}

size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

// Per device and instantiation: the dynamic shared memory allowed so far,
// and the blocks an SM holds at the last size asked for.
struct Launched {
  int smem_allowed = 0;
  int smem_for = -1;
  int per_sm = 0;
};
Launched g_launched[64][3];
int g_sms[64];
int g_smem_optin[64];

template <int NK, int MT, int TI>
int launch(const Net& net, Problem& pb, int v, cudaStream_t stream) {
  auto kernel = inr_mlp_kernel<NK, MT, TI>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  dev &= 63;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_smem_optin[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sms[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int L = net.n_layers, H1 = net.width[1];
  // Layout: hidden W^T (all, or one slot), head, biases, W1_int, terms,
  // features.
  size_t w_all = 0, w_max = 0;
  for (int l = 1; l < L - 1; ++l) {
    const size_t sz =
        align16((size_t)net.width[l + 1] * (net.width[l] + kPad) * 2);
    w_all += sz;
    w_max = sz > w_max ? sz : w_max;
  }
  int n_bias = kMaxC;
  for (int l = 1; l < L - 1; ++l) n_bias += net.width[l + 1];
  const size_t fixed =
      align16((size_t)kMaxC * (net.width[L - 1] + kPad) * 2) +
      align16((size_t)n_bias * 4) + align16((size_t)pb.M * H1 * 4) +
      align16(((size_t)(TI + kTileJ) * (H1 + kTermPad) + H1) * 4) +
      align16((size_t)(TI + kTileJ + 1) * (1 + 2 * pb.K) * 4);
  pb.resident = fixed + w_all <= (size_t)g_smem_optin[dev];
  const size_t smem = fixed + (pb.resident ? w_all : w_max);
  if (smem > (size_t)g_smem_optin[dev] ||
      (!pb.resident && !Traits<NK>::kStreams))
    return (int)cudaErrorInvalidValue;
  size_t off = 0;
  for (int l = 1; l < L - 1; ++l) {
    pb.off_w[l] = (int)off;
    if (pb.resident)
      off += align16((size_t)net.width[l + 1] * (net.width[l] + kPad) * 2);
  }
  if (!pb.resident) off = w_max;
  pb.off_head = (int)off;
  off += align16((size_t)kMaxC * (net.width[L - 1] + kPad) * 2);
  pb.off_bias = (int)off;
  int boff = 0;
  for (int l = 1; l < L; ++l) {
    pb.boff[l] = boff;
    boff += net.width[l + 1];
  }
  off += align16((size_t)n_bias * 4);
  pb.off_w1i = (int)off;
  off += align16((size_t)pb.M * H1 * 4);
  pb.off_terms = (int)off;
  off += align16(((size_t)(TI + kTileJ) * (H1 + kTermPad) + H1) * 4);
  pb.off_feat = (int)off;

  pb.tiles_i = (pb.Oa + TI - 1) / TI;
  pb.tiles_j = (pb.Ob + kTileJ - 1) / kTileJ;
  pb.tiles = pb.B * pb.tiles_i * pb.tiles_j;
  Launched& st = g_launched[dev][v];
  if ((int)smem > st.smem_allowed) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    st.smem_allowed = (int)smem;
  }
  if (st.smem_for != (int)smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&st.per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    st.smem_for = (int)smem;
  }
  if (st.per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const int resident_blocks = st.per_sm * g_sms[dev];
  const int grid = pb.tiles < resident_blocks ? pb.tiles : resident_blocks;
  kernel<<<grid, kThreads, smem, stream>>>(net, pb);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K3 on `stream`: labels (B, Oa, Ob) int32 into `out`. `weights`
// holds 2 * n_layers device pointers (W0, b0, W1, b1, ...: float32, W
// (in, out) row-major), `widths` n_layers + 1 ints (the first layer's
// fan-in, then each layer's fan-out). The caller checks the shapes: hidden
// widths multiples of 16 up to 256, 1..8 classes, 1..4 intensities, 2..16
// layers. c_k, c_a, c_b: the coordinate (0, 1, 2 = x, y, z) the plane, row
// and column coordinates are. Returns a cudaError_t (0 on success).
extern "C" int mrt_inr_mlp(const void* x, long long sb, long long si,
                           long long sj, long long sm, const void* a_n,
                           const void* b_n, const void* k_n, void* out, int B,
                           int Oa, int Ob, int M, int K, int c_k, int c_a,
                           int c_b, const void* const* weights,
                           const int* widths, int n_layers, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || M < 1 || M > kMaxM ||
      K < 0 || widths[n_layers] < 1 || widths[n_layers] > kMaxC)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Oa <= 0 || Ob <= 0) return 0;
  Net net;
  int widest = 0;
  for (int l = 0; l < n_layers; ++l) {
    net.W[l] = static_cast<const float*>(weights[2 * l]);
    net.b[l] = static_cast<const float*>(weights[2 * l + 1]);
  }
  for (int l = 0; l <= n_layers; ++l) {
    net.width[l] = widths[l];
    if (l > 0 && l < n_layers) {
      if (widths[l] < 16 || widths[l] > 256 || widths[l] % 16)
        return (int)cudaErrorInvalidValue;
      widest = widths[l] > widest ? widths[l] : widest;
    }
  }
  net.n_layers = n_layers;
  Problem pb;
  pb.x = static_cast<const float*>(x);
  pb.sb = sb;
  pb.si = si;
  pb.sj = sj;
  pb.sm = sm;
  pb.a_n = static_cast<const float*>(a_n);
  pb.b_n = static_cast<const float*>(b_n);
  pb.k_n = static_cast<const float*>(k_n);
  pb.out = static_cast<int*>(out);
  pb.B = B;
  pb.Oa = Oa;
  pb.Ob = Ob;
  pb.M = M;
  pb.K = K;
  pb.c_k = c_k;
  pb.c_a = c_a;
  pb.c_b = c_b;
  const cudaStream_t s = (cudaStream_t)stream;
  if (widest <= 64) return launch<4, 2, 32>(net, pb, 0, s);
  if (widest <= 128) return launch<8, 2, 32>(net, pb, 1, s);
  return launch<16, 1, 16>(net, pb, 2, s);
}
