// K4 backward to the features alone on the tensor cores (bf16):
// field_mma_bwd_feat, for the watermark stage's frozen backbone.  Design,
// rounding and bounds: field_mma.cuh.

#include "field_mma.cuh"

namespace {

// Whether any of the warp tile's samples carries a nonzero cotangent.
template <int ROWS>
__device__ __forceinline__ bool tile_live(const float* __restrict__ g_sigma,
                                          const float* __restrict__ g_rgb, long long row0,
                                          long long M, int lane) {
  const long long m = row0 + lane;
  const bool live = lane < ROWS && m < M &&
                    (g_sigma[m] != 0.0f || g_rgb[m * 3 + 0] != 0.0f || g_rgb[m * 3 + 1] != 0.0f ||
                     g_rgb[m * 3 + 2] != 0.0f);
  return __any_sync(0xffffffffu, live);
}

template <class D>
__global__ void __launch_bounds__(D::THREADS, D::MIN_BLOCKS)
    field_mma_bwd_feat(const float* __restrict__ feat, const float* __restrict__ dirs,
                       const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ g_sigma,
                       const float* __restrict__ g_rgb, float* __restrict__ g_feat, long long M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* fbuf = reinterpret_cast<float*>(smem + 2 * D::N_PACK) + warp * 2 * D::FTILE;
  const uint32_t w = smem_u32(smem);
  const long long n_tiles = (M + D::ROWS - 1) / D::ROWS;
  const long long stride = (long long)gridDim.x * D::WARPS;
  long long tile = (long long)blockIdx.x * D::WARPS + warp;
  bool live = tile < n_tiles && tile_live<D::ROWS>(g_sigma, g_rgb, tile * D::ROWS, M, lane);
  if (live) load_feat_tile<D>(fbuf, feat, tile * D::ROWS, M, lane);
  cp_async_commit();
  stage_weights<D>(wpack, smem);
  __syncthreads();

  for (int buf = 0; tile < n_tiles; tile += stride, buf ^= 1) {
    const long long next = tile + stride;
    const bool live_next =
        next < n_tiles && tile_live<D::ROWS>(g_sigma, g_rgb, next * D::ROWS, M, lane);
    if (live_next) load_feat_tile<D>(fbuf + (buf ^ 1) * D::FTILE, feat, next * D::ROWS, M, lane);
    cp_async_commit();
    const long long row0 = tile * D::ROWS;
    if (!live) {
      constexpr int PIECES = D::IN / 4;
#pragma unroll
      for (int j = 0; j < D::ROWS * PIECES / 32; ++j) {
        const int i = j * 32 + lane;
        const long long m = row0 + i / PIECES;
        if (m < M)
          reinterpret_cast<float4*>(g_feat + m * D::IN)[i % PIECES] =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      float dv[D::RT][2][3];
      load_dirs(dirs, row0, g, M, dv);
      cp_async_wait<1>();
      __syncwarp();
      // ---- the forward again, with the same fragments; keep the masks
      uint32_t ax[D::RT][D::KIN / 16][4];
      feat_frags<D>(fbuf + buf * D::FTILE, g, t, ax);
      float o[D::RT][2][4];
      uint32_t mask_h[D::RT], mask_c1[D::RT], mask_c2[D::RT];
      sigma_mlp<D>(ax, w, lane, o, mask_h);
      float c3[D::RT][1][4];
      colour_mlp<D>(dv, o, w, lane, t, c3, mask_c1, mask_c2);
      // ---- the colour MLP's cotangent (1): g_rgb * s(1-s), as an A fragment
      // over the last layer's 8 (padded to 16) outputs
      uint32_t agc[D::RT][1][4];
#pragma unroll
      for (int r = 0; r < D::RT; ++r) {
        float gc[2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long m = row0 + r * 16 + g + 8 * hh;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = 2 * t + q;
            const float gr = (m < M && col < 3) ? g_rgb[m * 3 + col] : 0.0f;
            const float s = sigmoid_of(bf16_round(c3[r][0][2 * hh + q]));
            gc[hh][q] = bf16_round(gr * (s * (1.0f - s)));
          }
        }
        agc[r][0][0] = pack_bf16(gc[0][0], gc[0][1]);
        agc[r][0][1] = pack_bf16(gc[1][0], gc[1][1]);
        agc[r][0][2] = 0u;
        agc[r][0][3] = 0u;
      }
      // ---- colour MLP, input cotangents only (2)
      uint32_t agh[D::RT][1][4];
      {
        uint32_t ag1[D::RT][D::HC / 16][4];
        {
          uint32_t ag2[D::RT][D::HC / 16][4];
          {
            float acc[D::RT][D::HC / 8][4];
            mma_layer_t<D::HC / 8, 0, D::LD_C2, true>(agc, w + 2u * D::O_C2, acc, lane);
#pragma unroll
            for (int r = 0; r < D::RT; ++r) masked_frags<D::HC / 8>(acc[r], mask_c2[r], ag2[r]);
          }
          float acc[D::RT][D::HC / 8][4];
          mma_layer_t<D::HC / 8, 0, D::LD_C1, false>(ag2, w + 2u * D::O_C1, acc, lane);
#pragma unroll
          for (int r = 0; r < D::RT; ++r) masked_frags<D::HC / 8>(acc[r], mask_c1[r], ag1[r]);
        }
        // the cotangent of o: Wc0' rows 16-31; column 16 (o[0]'s, a zero row)
        // takes trunc_exp's clamped VJP of sigma instead (1)
        float go[D::RT][2][4];
        mma_layer_t<2, 2, D::LD_C0, false>(ag1, w + 2u * D::O_C0, go, lane);
#pragma unroll
        for (int r = 0; r < D::RT; ++r) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) go[r][j][e] = bf16_round(go[r][j][e]);
          if (t == 0) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const long long m = row0 + r * 16 + g + 8 * hh;
              const float gs = m < M ? g_sigma[m] : 0.0f;
              go[r][0][2 * hh] = bf16_round(gs * expf(ngp_clip(o[r][0][2 * hh], -15.0f, 15.0f)));
            }
          }
          agh[r][0][0] = pack_bf16(go[r][0][0], go[r][0][1]);
          agh[r][0][1] = pack_bf16(go[r][0][2], go[r][0][3]);
          agh[r][0][2] = pack_bf16(go[r][1][0], go[r][1][1]);
          agh[r][0][3] = pack_bf16(go[r][1][2], go[r][1][3]);
        }
      }
      // ---- sigma MLP, input cotangents (2)
      float gx[D::RT][D::IN / 8][4];
      {
        uint32_t agh1[D::RT][D::HID / 16][4];
        {
          float acc[D::RT][D::HID / 8][4];
          mma_layer_t<D::HID / 8, 0, D::LD_S1, false>(agh, w + 2u * D::O_S1, acc, lane);
#pragma unroll
          for (int r = 0; r < D::RT; ++r) masked_frags<D::HID / 8>(acc[r], mask_h[r], agh1[r]);
        }
        mma_layer_t<D::IN / 8, 0, D::LD_S0, false>(agh1, w, gx, lane);
      }
#pragma unroll
      for (int r = 0; r < D::RT; ++r)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long m = row0 + r * 16 + g + 8 * hh;
          if (m >= M) continue;
#pragma unroll
          for (int j = 0; j < D::IN / 8; ++j)
            *reinterpret_cast<float2*>(g_feat + m * D::IN + 8 * j + 2 * t) =
                make_float2(bf16_round(gx[r][j][2 * hh]), bf16_round(gx[r][j][2 * hh + 1]));
        }
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
    live = live_next;
  }
  cp_async_wait<0>();
}

template <int IN, int HID, int OUT1, int HC>
int launch_bwd_feat(const void* feat, const void* dirs, const void* wpack, const void* g_sigma,
                    const void* g_rgb, void* g_feat, long long M, cudaStream_t s) {
  using D = BwdDims<IN, HID, OUT1, HC>;
  auto kernel = field_mma_bwd_feat<D>;
  int blocks = 0;
  const int rc = persistent_blocks<D>(kernel, M, &blocks);
  if (rc != 0) return rc;
  kernel<<<blocks, D::THREADS, D::SMEM, s>>>((const float*)feat, (const float*)dirs,
                                             (const __nv_bfloat16*)wpack, (const float*)g_sigma,
                                             (const float*)g_rgb, (float*)g_feat, M);
  NGP_RETURN_LAST_ERROR();
}

}  // namespace

extern "C" int ngp_field_mma_bwd_feat(const void* feat, const void* dirs, const void* wpack,
                                      const void* g_sigma, const void* g_rgb, void* g_feat,
                                      long long M, int in_dim, int hidden, int out1,
                                      int hidden_color, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dim == 32 && hidden == 64 && out1 == 16 && hidden_color == 64)
    return launch_bwd_feat<32, 64, 16, 64>(feat, dirs, wpack, g_sigma, g_rgb, g_feat, M, s);
  if (in_dim == 8 && hidden == 16 && out1 == 16 && hidden_color == 16)
    return launch_bwd_feat<8, 16, 16, 16>(feat, dirs, wpack, g_sigma, g_rgb, g_feat, M, s);
  return (int)cudaErrorInvalidValue;
}
