// Device helpers shared by the K4 SIMT kernels (field.cu, field_feat.cu,
// field_bwd.cu): the degree-4 SH encoding, the layer widths (the
// tensor-core kernels' too), and the tiled
// kernels' shared-memory plan, per-layer product, forward steps and
// weight-gradient product.  The sources that include it are compiled with
// -fmad=false.
#pragma once

#include <cuda_bf16.h>

#define SH_DIM 16

// The widths (IN, HID, OUT1, HC) every K4 source is built for, one X(...) a
// width: the NGPConfig defaults at 16 levels x 2 features and 8 x 4 (IN =
// 32), at 8 x 2 (IN = 16), at 16 x 4 and 32 x 2 (IN = 64), and the narrow
// test model (IN = 8).  The same list is ops/_cuda.py:FIELD_WIDTHS.  ptxas
// takes tens of seconds on each width of the SIMT sources, so ops/_cuda.py
// compiles them once a width (-DNGP_IN=.. -DNGP_HID=.. -DNGP_OUT1=..
// -DNGP_HC=..: the object instantiates that width's launchers) and once
// without NGP_IN (the C entry points, which call the launchers of every
// width), all in parallel.
#define NGP_FIELD_WIDTHS(X) X(32, 64, 16, 64) X(16, 64, 16, 64) X(64, 64, 16, 64) X(8, 16, 16, 16)
// The tensor-core kernels (field_mma*.cu, the bf16 route) are built for
// those widths and for IN = 128 (16 levels x 8 features and 32 x 4; 12 x 8
// runs at it zero-padded).  The same list is ops/_cuda.py:MMA_WIDTHS.
#define NGP_MMA_WIDTHS(X) \
  X(32, 64, 16, 64) X(16, 64, 16, 64) X(64, 64, 16, 64) X(8, 16, 16, 16) X(128, 64, 16, 64)

// ops/sh.py:sh_encode at degree 4, term for term in the same order.
__device__ __forceinline__ void sh4(float x, float y, float z, float* o) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  o[0] = 0.28209479177387814f;
  o[1] = -0.4886025119029199f * y;
  o[2] = 0.4886025119029199f * z;
  o[3] = -0.4886025119029199f * x;
  o[4] = 1.0925484305920792f * xy;
  o[5] = -1.0925484305920792f * yz;
  o[6] = 0.31539156525252005f * (2.0f * zz - xx - yy);
  o[7] = -1.0925484305920792f * xz;
  o[8] = 0.5462742152960396f * (xx - yy);
  o[9] = -0.5900435899266435f * y * (3.0f * xx - yy);
  o[10] = 2.890611442640554f * xy * z;
  o[11] = -0.4570457994644658f * y * (4.0f * zz - xx - yy);
  o[12] = 0.3731763325901154f * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  o[13] = -0.4570457994644658f * x * (4.0f * zz - xx - yy);
  o[14] = 1.445305721320277f * z * (xx - yy);
  o[15] = -0.5900435899266435f * x * (xx - 3.0f * yy);
}

template <int IN, int HID, int OUT1, int HC>
struct FieldDims {
  static constexpr int CIN = SH_DIM + OUT1 - 1;
  static constexpr int N_S0 = IN * HID, N_S1 = HID * OUT1;
  static constexpr int N_C0 = CIN * HC, N_C1 = HC * HC, N_C2 = HC * 3;
  static constexpr int N_W = N_S0 + N_S1 + N_C0 + N_C1 + N_C2;
};

// ------------------------------------------------------ the tiled SIMT kernels
// field.cu:field_fwd, field_feat.cu:field_bwd_feat and field_bwd.cu:
// field_bwd (whose plan, with a third buffer, is its own): a block of T threads
// walks tiles of T samples (a persistent grid); wherever the work is per
// sample, thread t takes sample t of the tile.  Dynamic shared memory holds
// two activation buffers P and Q of ROWS rows of T floats ([row][sample]:
// rows 16-byte aligned, a warp's reads of 8 consecutive float4 conflict-free),
// then (backward only) one 64-bit ReLU mask a sample, the weights as
// mlp_flat lays them out, and (backward only) the transposed weights the
// input cotangents read and the queue of live samples.  The wrapper
// computes the same bytes
// (models/ngp.py:simt_launch) and the launcher refuses any other.
template <int IN, int HID, int OUT1, int HC, int T, bool BWD>
struct SimtDims {
  static constexpr int CIN = SH_DIM + OUT1 - 1;
  static constexpr int N_W = FieldDims<IN, HID, OUT1, HC>::N_W;
  static constexpr int ROWS = (IN > HID ? IN : HID) > (HC > CIN ? HC : CIN)
                                  ? (IN > HID ? IN : HID)
                                  : (HC > CIN ? HC : CIN);
  // the transposed Wc1, Wc0's geo rows (and a zero column for gh[0]), Ws1, Ws0
  static constexpr int N_WT = BWD ? HC * HC + HC * OUT1 + OUT1 * HID + HID * IN : 0;
  // (backward only) the queue of live samples, 2T indices, then 16 ints of
  // scratch (the warps' counts of live samples, a chunk's number)
  static constexpr size_t SMEM =
      sizeof(float) * (2 * ROWS * T + N_W + N_WT) +
      (BWD ? sizeof(unsigned long long) * T + sizeof(long long) * 2 * T + sizeof(int) * 16 : 0);
  static_assert(T / 32 + 1 <= 16, "the scratch holds a count a warp and a chunk");
  static_assert(N_W % 4 == 0 && (ROWS * T) % 4 == 0, "the weights must stay 16-byte aligned");
};

// One layer's product over a tile: out[s][n] = sum_{r < R} act[r][s] * B[r][n],
// act in [row][sample] layout (T samples a row, rows LD floats apart), B
// row-major with N columns: the forward's W [K][N] or the backward's
// transposed W.  Each of the T threads owns RM samples x RN outputs and
// keeps their sums in registers; per r it loads RM activations and RN
// weights (16-byte shared loads) and does RM x RN FMAs.  Every output
// starts at 0.0f and adds fmaf(act, B, acc) over r ascending (the order of
// the one-thread-a-sample kernels these replaced, whose sums they equal bit
// for bit), whatever the thread map.  Samples: 4 consecutive (RM = 4), or
// those and the same 4 in the tile's second half (RM = 8); outputs: RN
// consecutive, or 4 and the same 4 in the second half (RN = 8).  Lanes: 8
// sample groups x 4 output groups a warp.
template <int T, int N, int LD = T>
struct MicroTile {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "product widths 8, 16, 32 or 64");
  static constexpr int RN = N == 64 ? 8 : (N == 8 ? 2 : 4);
  static constexpr int RM = N / RN;
  static constexpr int NX = T / RM;  // sample groups
  static_assert(T % 32 == 0 && NX % 8 == 0 && (N / RN) % 4 == 0 &&
                    (NX / 8) * (N / RN / 4) * 32 == T,
                "one thread a micro-tile");
  int tx, ty;

  __device__ __forceinline__ MicroTile() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    tx = (warp % (NX / 8)) * 8 + (lane & 7);
    ty = (warp / (NX / 8)) * 4 + (lane >> 3);
  }
  // the first of 4 consecutive samples (h: which half, RM = 8)
  __device__ __forceinline__ int sample4(int h) const { return h * (T / 2) + 4 * tx; }
  // the i-th sample and the jj-th output of this thread
  __device__ __forceinline__ int sample(int i) const { return sample4(i >> 2) + (i & 3); }
  __device__ __forceinline__ int out(int jj) const {
    return RN == 8 ? (jj >> 2) * (N / 2) + 4 * ty + (jj & 3) : RN * ty + jj;
  }

  template <int R>
  __device__ __forceinline__ void mm(const float* __restrict__ act, const float* __restrict__ B,
                                     float (&acc)[RM][RN]) const {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
    }
    const float* a_p = act + 4 * tx;
    const float* b_p = B + (RN == 8 ? 4 : RN) * ty;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      float a[RM], b[RN];
#pragma unroll
      for (int h = 0; h < RM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(a_p + r * LD + h * (T / 2));
        a[4 * h + 0] = v.x;
        a[4 * h + 1] = v.y;
        a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
      if constexpr (RN == 2) {
        const float2 v = *reinterpret_cast<const float2*>(b_p + r * N);
        b[0] = v.x;
        b[1] = v.y;
      } else {
#pragma unroll
        for (int h = 0; h < RN / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(b_p + r * N + h * (N / 2));
          b[4 * h + 0] = v.x;
          b[4 * h + 1] = v.y;
          b[4 * h + 2] = v.z;
          b[4 * h + 3] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  // out[n][s] = f(sum, n, s) for this thread's outputs, as float4 over samples
  template <class F>
  __device__ __forceinline__ void store(float* dst, const float (&acc)[RM][RN],
                                        F f) const {
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = out(j);
#pragma unroll
      for (int h = 0; h < RM / 4; ++h) {
        const int s = sample4(h);
        float4* p = reinterpret_cast<float4*>(dst + n * LD + s);
        *p = make_float4(f(acc[4 * h + 0][j], n, s + 0), f(acc[4 * h + 1][j], n, s + 1),
                         f(acc[4 * h + 2][j], n, s + 2), f(acc[4 * h + 3][j], n, s + 3));
      }
    }
  }
};

// dst = f(act[0:R] x B) over the tile, each thread its micro-tile
template <int T, int N, int R, int LD = T, class F>
__device__ __forceinline__ void tile_layer(const float* act, const float* B, float* dst, F f) {
  using MT = MicroTile<T, N, LD>;
  const MT mt;
  float acc[MT::RM][MT::RN];
  mt.template mm<R>(act, B, acc);
  mt.store(dst, acc, f);
}

struct Relu {
  __device__ __forceinline__ float operator()(float v, int, int) const { return fmaxf(v, 0.0f); }
};
struct Same {
  __device__ __forceinline__ float operator()(float v, int, int) const { return v; }
};

// The tiled kernels' forward over a tile in steps, thread t taking sample m
// (zeros where !valid); each step ends with the block synchronised.
// feat -> P rows 0..IN-1
template <int IN, int T, int LD = T>
__device__ __forceinline__ void tile_feat(const float* __restrict__ feat, long long m, bool valid,
                                          float* P) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < IN / 4; ++k) {
    const float4 v = valid ? reinterpret_cast<const float4*>(feat + m * IN)[k]
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    P[(4 * k + 0) * LD + t] = v.x;
    P[(4 * k + 1) * LD + t] = v.y;
    P[(4 * k + 2) * LD + t] = v.z;
    P[(4 * k + 3) * LD + t] = v.w;
  }
  __syncthreads();
}

// h = relu(feat Ws0) -> Q; o = h Ws1 -> P rows 15..15 + OUT1 - 1, so that
// o[1:] (geo) lands where the colour MLP reads it, after SH4's 16 rows
template <int IN, int HID, int OUT1, int T, int LD = T>
__device__ __forceinline__ void tile_sigma_mlp(float* P, float* Q, const float* Ws0,
                                               const float* Ws1) {
  tile_layer<T, HID, IN, LD>(P, Ws0, Q, Relu());
  __syncthreads();
  tile_layer<T, OUT1, HID, LD>(Q, Ws1, P + (SH_DIM - 1) * LD, Same());
  __syncthreads();
}

// SH4 of sample m's direction -> P rows 0..15 (row 15 held o[0]: a thread
// reads its own o[0] before)
template <int T, int LD = T>
__device__ __forceinline__ void tile_sh4(const float* __restrict__ dirs, long long m, bool valid,
                                         float* P) {
  float c[SH_DIM];
  if (valid) {
    sh4(dirs[m * 3 + 0], dirs[m * 3 + 1], dirs[m * 3 + 2], c);
  } else {
#pragma unroll
    for (int k = 0; k < SH_DIM; ++k) c[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < SH_DIM; ++k) P[k * LD + threadIdx.x] = c[k];
  __syncthreads();
}

// c1 = relu(c Wc0) -> Q; c2 = relu(c1 Wc1) -> C2 (P, or a third buffer
// where c must outlive it)
template <int CIN, int HC, int T, int LD = T>
__device__ __forceinline__ void tile_colour_mlp(const float* P, float* Q, const float* Wc0,
                                                const float* Wc1, float* C2) {
  tile_layer<T, HC, CIN, LD>(P, Wc0, Q, Relu());
  __syncthreads();
  tile_layer<T, HC, HC, LD>(Q, Wc1, C2, Relu());
  __syncthreads();
}

// the colour logits of thread t's sample from c2 (in P), each an fmaf
// chain over k ascending
template <int HC, int T, int LD = T>
__device__ __forceinline__ void colour_logits(const float* P, const float* Wc2, float (&c3)[3]) {
  c3[0] = c3[1] = c3[2] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < HC; ++k) {
    const float v = P[k * LD + threadIdx.x];
#pragma unroll
    for (int j = 0; j < 3; ++j) c3[j] = fmaf(v, Wc2[k * 3 + j], c3[j]);
  }
}

// One layer's weight gradient over a tile (field_bwd.cu): dW[k][j] =
// sum_{s < n} A[k][s] * G[j][s], A the layer's input (K rows) and G the
// cotangent of its pre-activation output (J rows), both [row][sample] with
// rows LD floats apart.  The sum runs over the samples, so the map is not
// MicroTile's: thread (kg, jg) = (tid / JG, tid % JG) owns the RK x RJ
// entries k = kg + KG i, j = jg + JG jj (those with k < K and j < J) and,
// per 4 samples, loads one float4 from each of its RK rows of A and RJ
// rows of G for 4 RK RJ FMAs.  A quarter-warp's 8 lanes read either one
// address (a broadcast) or rows that follow each other: LD = T + 4 puts
// consecutive rows 4 banks apart, so those 8 float4 fall in distinct banks.
// Each entry is one register's fmaf chain over s ascending from 0.0f
// (samples past n carry zero cotangents and add +0.0f).  The tile's sum
// then goes to dst, the entry in the block's row of partials in global
// memory: stored at the block's first tile (first), else added to the
// value the same thread stored there at its earlier tiles, which it loads
// before the product so that the load's latency hides behind it.
template <int T, int LD, int K, int J>
struct WgradTile {
  static constexpr int JG = J >= 64 ? (K >= 64 ? 8 : 16) : 4;
  static constexpr int KG = T / JG;
  static constexpr int RK = (K + KG - 1) / KG, RJ = (J + JG - 1) / JG;
  static_assert(T % JG == 0 && LD % 32 == 4, "a thread a (kg, jg); rows 4 banks apart");

  static __device__ __forceinline__ void run(const float* __restrict__ A,
                                             const float* __restrict__ G, int n,
                                             float* __restrict__ dst, bool first) {
    const int jg = threadIdx.x % JG, kg = threadIdx.x / JG;
    float acc[RK][RJ], old[RK][RJ];
#pragma unroll
    for (int i = 0; i < RK; ++i) {
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int k = kg + KG * i, j = jg + JG * jj;
        acc[i][jj] = 0.0f;
        old[i][jj] = !first && k < K && j < J ? dst[k * J + j] : 0.0f;
      }
    }
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 2
    for (int s = 0; s < n; s += 4) {
      float4 a[RK], g[RJ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int k = kg + KG * i;
        a[i] = k < K ? *reinterpret_cast<const float4*>(A + k * LD + s) : zero;
      }
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int j = jg + JG * jj;
        g[jj] = j < J ? *reinterpret_cast<const float4*>(G + j * LD + s) : zero;
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) {
          float v = fmaf(a[i].x, g[jj].x, acc[i][jj]);
          v = fmaf(a[i].y, g[jj].y, v);
          v = fmaf(a[i].z, g[jj].z, v);
          acc[i][jj] = fmaf(a[i].w, g[jj].w, v);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i) {
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int k = kg + KG * i, j = jg + JG * jj;
        if (k < K && j < J) dst[k * J + j] = first ? acc[i][jj] : old[i][jj] + acc[i][jj];
      }
    }
  }
};
