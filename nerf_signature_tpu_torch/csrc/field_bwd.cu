// K4 backward with the weight gradient (field_bwd + wgrad_reduce), the fp32
// route: replaces JAX's autodiff of nerf_signature_tpu/models/mlp.py:
// mlp_apply through models/ngp.py:_sigma_head and ngp_color, with
// trunc_exp's clamped VJP (ops/activation.py:24) and the sigmoid.  Given
// feat [M, IN], dirs [M, 3], the flat weights and the cotangents g_sigma
// [M] and g_rgb [M, 3], it returns g_feat [M, IN] and g_weights [N_W]
// (fp32).  No gradient flows to dirs (SH has no parameters, rays carry
// none).  In fp32 mlp_apply rounds nowhere between layers and neither does
// this kernel; the bf16 route runs on the tensor cores
// (field_mma_bwd_full.cu).
//
// What bounds it on the H100: the operations of the live samples (those
// with a nonzero cotangent: a train step's padded slots carry none).  Per
// live sample the forward, the input cotangents and the weight gradient's
// outer products, ~6 flops a weight (56 kFLOP at the default widths), on
// the fp32 FMA units; per sample of the call its cotangents read and g_feat
// written (284 B at IN = 32).
//
// Design: the tiled products of field_common.cuh over tiles of T = 128
// queued live samples, one 128-thread block an SM (the wrapper passes the
// count; BwdDims is the shared-memory plan, models/ngp.py:simt_launch
// computes the same bytes and the launcher refuses any other).
// - Queue.  Block b takes chunks of 32 samples (a warp's) by a fixed
//   assignment: b, b + G, b + 2G, ... (G blocks), U a warp a round, so
//   that a thread's 4 U cotangent loads are in flight at once.  A block
//   scan (a ballot a chunk) appends the round's live samples to the queue
//   in the block's chunk order and each warp writes g_feat 0 for its
//   chunks' dead samples (16-byte stores over the chunk's rows).  A full
//   queue, or the last one, makes a tile.  The samples a block sums, and
//   the order, depend on the grid alone: g_weights is bit-equal from run
//   to run on a given grid (a counter, as field_feat.cu:field_bwd_feat
//   takes, would make them depend on timing).  Chunks of a warp, not of a
//   tile: live samples cluster (the rays that hit), and 32-sample chunks
//   spread them over the blocks more evenly (at the train step's
//   uncompacted samples, 8% live, the busiest block's share falls from
//   1061 to 576 live samples, 9 to 5 tiles; a compacted step packs its
//   live samples first, where either spreads them evenly).
// - Buffers.  Three activation buffers P, Q, R of ROWS rows of T floats,
//   rows LD = T + 4 floats apart ([row][sample]; the padding puts
//   consecutive rows 4 banks apart for WgradTile), G3 (gc3, [4][LD]), the
//   weights and their transposes (field_feat.cu's), the queue and the
//   ballots.  Per tile, each weight gradient dW = A^T G runs while its
//   input A and output cotangent G are both held:
//     feat -> P; h -> Q; o -> P rows 15..30 (o[0] kept per sample); SH4 ->
//     P rows 0..15 (P = c); c1 -> Q; c2 -> R; gc3 -> G3 per sample;
//     dWc2 = c2^T gc3 (R, G3); g2 = mask(c2) (Wc2 gc3) over R in place;
//     dWc1 = c1^T g2 (Q, R); g1 = mask(c1) (Wc1 g2) over Q in place;
//     dWc0 = c^T g1 (P, Q; the SH rows too) beside gh[1:] = Wc0[16:31] g1
//     -> R rows 0..15, then gh[0] (trunc_exp's VJP) per sample;
//     the sigma MLP again, as field.cu's old kernel did: feat -> P, h -> Q;
//     dWs1 = h^T gh (Q, R); gh1 = mask(h) (Ws1 gh) over Q in place;
//     dWs0 = feat^T gh1 (P, Q) beside g_feat = Ws0 gh1 -> memory.
//   Every input cotangent is field_bwd_feat's product on field_bwd_feat's
//   operands, each output an fmaf chain from 0.0f over its row ascending:
//   g_feat is bit-equal to that kernel's and to the one-thread-a-sample
//   kernel's this replaced.
// - Where a block's dW lives.  In its row of partials [G, N_W] in global
//   memory (L2-resident: 4.9 MB at the default widths on 132 SMs): each
//   entry is owned by one thread (WgradTile's map), which stores its first
//   tile's sum there and adds each later tile's, with no barrier or atomic.
//   Not registers: 73 floats a thread beside a product's 64 accumulators
//   would spill.  Not shared memory: 45,568 B at IN = 64 do not fit beside
//   the buffers and the weights (BwdDims::SMEM, 192,640 B there).
// - Order of every sum.  A tile's entry: over its samples ascending (one
//   fmaf chain, WgradTile); a block's: its tiles in queue order, ((t0 + t1)
//   + t2) ...; g_weights: wgrad_reduce over the blocks in block order.  A
//   block with no live sample writes a row of zeros.

#include <limits.h>

#include "common.cuh"
#include "field_common.cuh"

#define NGP_BWD_T 128   // samples a tile = threads a block (models/ngp.py:SIMT_TILE)
#define NGP_BWD_LD 132  // the activation rows' stride in floats: T + 4
#define NGP_BWD_U 4     // chunks a warp scans a round (32 samples a chunk)

// The shared-memory plan of field_bwd (models/ngp.py:simt_launch, kind
// "bwd"): P, Q, R, G3, the weights, the transposed weights, the queue, the
// ballots.  ROWS >= 32: c has 31 rows and WgradTile<31, ..> covers 32.
template <int IN, int HID, int OUT1, int HC>
struct BwdDims {
  static constexpr int T = NGP_BWD_T, LD = NGP_BWD_LD, U = NGP_BWD_U, NWARP = T / 32;
  static constexpr int CIN = SH_DIM + OUT1 - 1;
  static constexpr int N_W = FieldDims<IN, HID, OUT1, HC>::N_W;
  static constexpr int ROWS = (IN > HID ? IN : HID) > (HC > 32 ? HC : 32)
                                  ? (IN > HID ? IN : HID)
                                  : (HC > 32 ? HC : 32);
  static constexpr int N_WT = HC * HC + HC * OUT1 + OUT1 * HID + HID * IN;
  static constexpr int QCAP = (U + 1) * T;  // fewer than T queued, then a round's U T
  static constexpr size_t SMEM = sizeof(float) * (3 * ROWS * LD + 4 * LD + N_W + N_WT) +
                                 sizeof(int) * QCAP + sizeof(unsigned) * U * NWARP;
  static_assert(CIN <= 32 && OUT1 + SH_DIM - 1 <= ROWS, "c and o fit P's rows");
  static_assert(N_W % 4 == 0 && N_WT % 4 == 0, "the weights stay 16-byte aligned");
};

template <int IN, int HID, int OUT1, int HC>
__global__ void __launch_bounds__(NGP_BWD_T, 1)
    field_bwd(const float* __restrict__ feat, const float* __restrict__ dirs,
              const float* __restrict__ weights, const float* __restrict__ g_sigma,
              const float* __restrict__ g_rgb, float* __restrict__ g_feat,
              float* __restrict__ partials, long long M) {
  using D = BwdDims<IN, HID, OUT1, HC>;
  using F = FieldDims<IN, HID, OUT1, HC>;
  constexpr int T = D::T, LD = D::LD, U = D::U, NWARP = D::NWARP, CIN = D::CIN;
  extern __shared__ __align__(16) float smem[];
  float* P = smem;
  float* Q = P + D::ROWS * LD;
  float* R = Q + D::ROWS * LD;
  float* G3 = R + D::ROWS * LD;     // [4][LD]: gc3 (row 3 never read)
  float* w_s = G3 + 4 * LD;
  float* WT1 = w_s + D::N_W;        // [HC][HC]:    Wc1[k][j] at [j][k]
  float* WT0 = WT1 + HC * HC;       // [HC][OUT1]:  Wc0[15 + jj][j] at [j][jj], jj = 0 zero
  float* WTs1 = WT0 + HC * OUT1;    // [OUT1][HID]: Ws1[k][j] at [j][k]
  float* WTs0 = WTs1 + OUT1 * HID;  // [HID][IN]:   Ws0[k][j] at [j][k]
  int* queue = reinterpret_cast<int*>(WTs0 + HID * IN);            // [QCAP] live samples
  unsigned* ballots = reinterpret_cast<unsigned*>(queue + D::QCAP);  // [U][NWARP]: a chunk's
  const float* Ws0 = w_s;
  const float* Ws1 = Ws0 + F::N_S0;
  const float* Wc0 = Ws1 + F::N_S1;
  const float* Wc1 = Wc0 + F::N_C0;
  const float* Wc2 = Wc1 + F::N_C1;
  for (int i = threadIdx.x; i < D::N_W; i += T) w_s[i] = weights[i];
  const float* gWs0 = weights;
  const float* gWs1 = gWs0 + F::N_S0;
  const float* gWc0 = gWs1 + F::N_S1;
  const float* gWc1 = gWc0 + F::N_C0;
  for (int i = threadIdx.x; i < HC * HC; i += T) WT1[i] = gWc1[(i % HC) * HC + i / HC];
  for (int i = threadIdx.x; i < HC * OUT1; i += T) {
    const int j = i / OUT1, jj = i % OUT1;
    WT0[i] = jj == 0 ? 0.0f : gWc0[(SH_DIM - 1 + jj) * HC + j];
  }
  for (int i = threadIdx.x; i < OUT1 * HID; i += T) WTs1[i] = gWs1[(i % HID) * OUT1 + i / HID];
  for (int i = threadIdx.x; i < HID * IN; i += T) WTs0[i] = gWs0[(i % IN) * HID + i / IN];
  // this block's row of partials, by layer
  float* dWs0 = partials + (long long)blockIdx.x * F::N_W;
  float* dWs1 = dWs0 + F::N_S0;
  float* dWc0 = dWs1 + F::N_S1;
  float* dWc1 = dWc0 + F::N_C0;
  float* dWc2 = dWc1 + F::N_C1;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long n_chunks = (M + 31) / 32;
  long long chunk = blockIdx.x;  // the first chunk of the next round
  int queued = 0;                // queue[0:queued], the same in every thread
  bool first = true;             // no tile summed yet
  __syncthreads();

  while (true) {
    // ---- scan rounds until a tile is queued: chunk k < U NWARP of a round
    // is chunk + k G, warp w taking k = u NWARP + w, lane l its sample l
    while (chunk < n_chunks && queued < T) {
      unsigned ballot[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long m = (chunk + (long long)(u * NWARP + warp) * gridDim.x) * 32 + lane;
        bool live = false;
        if (m < M) {  // the four loads issued together, then compared
          const float a = g_sigma[m], b = g_rgb[m * 3 + 0], c = g_rgb[m * 3 + 1],
                      d = g_rgb[m * 3 + 2];
          live = (a != 0.0f) | (b != 0.0f) | (c != 0.0f) | (d != 0.0f);
        }
        ballot[u] = __ballot_sync(0xffffffffu, live);
        if (lane == 0) ballots[u * NWARP + warp] = ballot[u];
      }
      __syncthreads();
      int at = queued;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int before = 0, total = 0;
#pragma unroll
        for (int w = 0; w < NWARP; ++w) {
          const int c = __popc(ballots[u * NWARP + w]);
          before += w < warp ? c : 0;
          total += c;
        }
        const long long c0 = (chunk + (long long)(u * NWARP + warp) * gridDim.x) * 32;
        if ((ballot[u] >> lane) & 1u)
          queue[at + before + __popc(ballot[u] & ((1u << lane) - 1u))] = (int)(c0 + lane);
        at += total;
        // g_feat = 0 for the chunk's dead samples, 16 bytes a store over its rows
        if (c0 < M) {
          const int rows = M - c0 < 32 ? (int)(M - c0) : 32;
          float4* out = reinterpret_cast<float4*>(g_feat + c0 * IN);
          for (int i = lane; i < rows * (IN / 4); i += 32) {
            if (!((ballot[u] >> (i / (IN / 4))) & 1u))
              out[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
      }
      queued = at;
      chunk += (long long)U * NWARP * gridDim.x;
      __syncthreads();  // the ballots read before the next round writes them
    }
    if (queued == 0) break;
    // ---- a tile of the first n queued samples, thread t taking sample t
    const int n = queued < T ? queued : T;
    const bool valid = t < n;
    const long long m = valid ? queue[t] : 0;
    const float gs = valid ? g_sigma[m] : 0.0f;
    const float gr[3] = {valid ? g_rgb[m * 3 + 0] : 0.0f, valid ? g_rgb[m * 3 + 1] : 0.0f,
                         valid ? g_rgb[m * 3 + 2] : 0.0f};
    // ---- the forward, recomputed: c stays in P, c1 in Q, c2 in R
    tile_feat<IN, T, LD>(feat, m, valid, P);
    tile_sigma_mlp<IN, HID, OUT1, T, LD>(P, Q, Ws0, Ws1);
    const float h0 = P[(SH_DIM - 1) * LD + t];
    tile_sh4<T, LD>(dirs, m, valid, P);
    tile_colour_mlp<CIN, HC, T, LD>(P, Q, Wc0, Wc1, R);
    // ---- per sample: the colour output's cotangent gc3 -> G3
    float gc3[3];
    {
      float c3[3];
      colour_logits<HC, T, LD>(R, Wc2, c3);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float s = 1.0f / (1.0f + expf(-c3[j]));
        gc3[j] = gr[j] * (s * (1.0f - s));
        G3[j * LD + t] = gc3[j];
      }
    }
    __syncthreads();
    WgradTile<T, LD, HC, 3>::run(R, G3, n, dWc2, first);  // dWc2 = c2^T gc3
    __syncthreads();
    // g2 = mask(c2) * (Wc2 gc3), over c2 in place
#pragma unroll 8
    for (int k = 0; k < HC; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) acc = fmaf(Wc2[k * 3 + j], gc3[j], acc);
      R[k * LD + t] = R[k * LD + t] > 0.0f ? acc : 0.0f;
    }
    __syncthreads();
    WgradTile<T, LD, HC, HC>::run(Q, R, n, dWc1, first);  // dWc1 = c1^T g2
    __syncthreads();
    // g1 = mask(c1) * (Wc1 g2), over c1 in place
    tile_layer<T, HC, HC, LD>(R, WT1, Q, [Q](float v, int n, int s) {
      return Q[n * LD + s] > 0.0f ? v : 0.0f;
    });
    __syncthreads();
    WgradTile<T, LD, CIN, HC>::run(P, Q, n, dWc0, first);  // dWc0 = c^T g1
    tile_layer<T, OUT1, HC, LD>(Q, WT0, R, Same());         // gh[1:] = Wc0[16:31] g1
    __syncthreads();
    R[t] = gs * expf(ngp_clip(h0, -15.0f, 15.0f));  // gh[0]: trunc_exp's clamped VJP
    // ---- the sigma MLP's forward again: feat -> P, h -> Q
    tile_feat<IN, T, LD>(feat, m, valid, P);
    tile_layer<T, HID, IN, LD>(P, Ws0, Q, Relu());
    __syncthreads();
    WgradTile<T, LD, HID, OUT1>::run(Q, R, n, dWs1, first);  // dWs1 = h^T gh
    __syncthreads();
    // gh1 = mask(h) * (Ws1 gh), over h in place
    tile_layer<T, HID, OUT1, LD>(R, WTs1, Q, [Q](float v, int n, int s) {
      return Q[n * LD + s] > 0.0f ? v : 0.0f;
    });
    __syncthreads();
    WgradTile<T, LD, IN, HID>::run(P, Q, n, dWs0, first);  // dWs0 = feat^T gh1
    {
      using MT = MicroTile<T, IN, LD>;  // g_feat = Ws0 gh1
      MT mt;
      float acc[MT::RM][MT::RN];
      mt.template mm<HID>(Q, WTs0, acc);
#pragma unroll
      for (int i = 0; i < MT::RM; ++i) {
        if (mt.sample(i) >= n) continue;
        float* row = g_feat + (long long)queue[mt.sample(i)] * IN;
        if constexpr (MT::RN == 2) {
          *reinterpret_cast<float2*>(row + mt.out(0)) = make_float2(acc[i][0], acc[i][1]);
        } else {
#pragma unroll
          for (int h = 0; h < MT::RN / 4; ++h)
            *reinterpret_cast<float4*>(row + mt.out(4 * h)) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                            acc[i][4 * h + 3]);
        }
      }
    }
    first = false;
    // ---- dequeue the tile: the rest to the front (a rest only behind a
    // full tile, n = T: thread t moves entries t + T k, each before it is
    // overwritten)
    __syncthreads();
    const int rest = queued - n;
    for (int i = t; i < rest; i += T) queue[i] = queue[n + i];
    queued = rest;
    __syncthreads();
  }
  if (first) {  // no live sample: this block adds nothing
    for (int i = t; i < F::N_W; i += T) dWs0[i] = 0.0f;
  }
}

// Sums the blocks' partials in block order.
static __global__ void wgrad_reduce(const float* __restrict__ partials, int n_blocks, int n_w,
                                    float* __restrict__ g_weights) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_w) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(long long)b * n_w + e];
  g_weights[e] = s;
}

template <int IN, int HID, int OUT1, int HC>
int launch_field_bwd(const void* feat, const void* dirs, const void* weights,
                     const void* g_sigma, const void* g_rgb, void* g_feat, void* partials,
                     void* g_weights, long long M, int n_blocks, long long smem,
                     cudaStream_t s) {
  using D = BwdDims<IN, HID, OUT1, HC>;
  if (smem != (long long)D::SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = field_bwd<IN, HID, OUT1, HC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)D::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, D::T, D::SMEM, s>>>(
      (const float*)feat, (const float*)dirs, (const float*)weights, (const float*)g_sigma,
      (const float*)g_rgb, (float*)g_feat, (float*)partials, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wgrad_reduce<<<ngp_blocks(D::N_W, 256), 256, 0, s>>>((const float*)partials, n_blocks, D::N_W,
                                                       (float*)g_weights);
  NGP_RETURN_LAST_ERROR();
}

#ifndef NGP_IN
#define NGP_EXTERN(IN, HID, OUT1, HC) \
  extern template int launch_field_bwd<IN, HID, OUT1, HC>(                                  \
      const void*, const void*, const void*, const void*, const void*, void*, void*, void*,  \
      long long, int, long long, cudaStream_t);
NGP_FIELD_WIDTHS(NGP_EXTERN)
#undef NGP_EXTERN

// partials: [n_blocks, N_W] fp32 scratch; n_blocks >= 1 blocks of 128
// threads with smem bytes of dynamic shared memory each
// (models/ngp.py:simt_launch; any other size is refused).  The queue holds
// int32 sample numbers: M < 2^31.
extern "C" int ngp_field_bwd(const void* feat, const void* dirs, const void* weights,
                             const void* g_sigma, const void* g_rgb, void* g_feat,
                             void* partials, void* g_weights, long long M, int n_blocks,
                             int in_dim, int hidden, int out1, int hidden_color, long long smem,
                             void* stream) {
  if (M < 0 || M > INT_MAX || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NGP_DISPATCH(IN, HID, OUT1, HC)                                     \
  if (in_dim == IN && hidden == HID && out1 == OUT1 && hidden_color == HC) \
    return launch_field_bwd<IN, HID, OUT1, HC>(feat, dirs, weights, g_sigma, g_rgb, g_feat,   \
                                               partials, g_weights, M, n_blocks, smem, s);
  NGP_FIELD_WIDTHS(NGP_DISPATCH)
#undef NGP_DISPATCH
  return (int)cudaErrorInvalidValue;
}
#else
template int launch_field_bwd<NGP_IN, NGP_HID, NGP_OUT1, NGP_HC>(
    const void*, const void*, const void*, const void*, const void*, void*, void*, void*, long long,
    int, long long, cudaStream_t);
#endif  // NGP_IN
