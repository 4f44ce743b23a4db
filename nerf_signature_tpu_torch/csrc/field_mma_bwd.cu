// K4 backward to the features alone on the tensor cores (bf16):
// field_mma_bwd_feat, for the watermark stage's frozen backbone: the
// backward chain of field_mma.cuh (bwd_chain) with no weight gradient, so
// nothing is staged.  Design, rounding and bounds: field_mma.cuh.

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
      uint32_t ax[D::RT][D::KIN / 16][4];
      feat_frags<D>(fbuf + buf * D::FTILE, g, t, ax);
      bwd_chain<D>(ax, dv, w, lane, row0, M, g_sigma, g_rgb, g_feat, NoStage());
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
    live = live_next;
  }
  cp_async_wait<0>();
}

template <int IN, int HID, int OUT1, int HC>
int launch_bwd_feat(const void* feat, const void* dirs, const void* wpack, const void* g_sigma,
                    const void* g_rgb, void* g_feat, long long M, long long smem,
                    cudaStream_t s) {
  using D = BwdDims<IN, HID, OUT1, HC>;
  auto kernel = field_mma_bwd_feat<D>;
  int blocks = 0;
  const int rc = persistent_blocks<D>(kernel, M, smem, &blocks);
  if (rc != 0) return rc;
  kernel<<<blocks, D::THREADS, D::SMEM, s>>>((const float*)feat, (const float*)dirs,
                                             (const __nv_bfloat16*)wpack, (const float*)g_sigma,
                                             (const float*)g_rgb, (float*)g_feat, M);
  NGP_RETURN_LAST_ERROR();
}

}  // namespace

// Widths: NGP_MMA_WIDTHS (field_common.cuh).  smem: the plan's dynamic
// shared bytes (models/ngp.py:mma_launch; any other size is refused).
extern "C" int ngp_field_mma_bwd_feat(const void* feat, const void* dirs, const void* wpack,
                                      const void* g_sigma, const void* g_rgb, void* g_feat,
                                      long long M, int in_dim, int hidden, int out1,
                                      int hidden_color, long long smem, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define NGP_DISPATCH(IN, HID, OUT1, HC)                                     \
  if (in_dim == IN && hidden == HID && out1 == OUT1 && hidden_color == HC) \
    return launch_bwd_feat<IN, HID, OUT1, HC>(feat, dirs, wpack, g_sigma, g_rgb, g_feat, M, \
                                              smem, s);
  NGP_MMA_WIDTHS(NGP_DISPATCH)
#undef NGP_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// The feature-only backward's compiled plan at these widths (plan_of: threads, shared
// bytes, blocks an SM, registers, local bytes), for models/ngp.py:mma_plan.
template <int IN, int HID, int OUT1, int HC>
static int plan_at(long long* out) {
  using D = BwdDims<IN, HID, OUT1, HC>;
  return plan_of<D>(field_mma_bwd_feat<D>, out);
}

extern "C" int ngp_field_mma_bwd_feat_plan(int in_dim, int hidden, int out1, int hidden_color,
                                           long long* out) {
#define NGP_DISPATCH(IN, HID, OUT1, HC)                                     \
  if (in_dim == IN && hidden == HID && out1 == OUT1 && hidden_color == HC) \
    return plan_at<IN, HID, OUT1, HC>(out);
  NGP_MMA_WIDTHS(NGP_DISPATCH)
#undef NGP_DISPATCH
  return (int)cudaErrorInvalidValue;
}
