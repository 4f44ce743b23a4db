// K4 forward on the tensor cores (bf16): field_mma_fwd.  Design, rounding
// and bounds: field_mma.cuh.

#include "field_mma.cuh"

namespace {

template <class D>
__global__ void __launch_bounds__(D::THREADS, D::MIN_BLOCKS)
    field_mma_fwd(const float* __restrict__ feat, const float* __restrict__ dirs,
                  const __nv_bfloat16* __restrict__ wpack, float* __restrict__ sigma,
                  float* __restrict__ geo, float* __restrict__ rgb, float* __restrict__ raw,
                  long long M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* fbuf = reinterpret_cast<float*>(smem + 2 * D::N_PACK) + warp * 2 * D::FTILE;
  const uint32_t w = smem_u32(smem);
  const long long n_tiles = (M + D::ROWS - 1) / D::ROWS;
  const long long stride = (long long)gridDim.x * D::WARPS;
  long long tile = (long long)blockIdx.x * D::WARPS + warp;
  if (tile < n_tiles) load_feat_tile<D>(fbuf, feat, tile * D::ROWS, M, lane);
  cp_async_commit();
  stage_weights<D>(wpack, smem);
  __syncthreads();

  for (int buf = 0; tile < n_tiles; tile += stride, buf ^= 1) {
    if (tile + stride < n_tiles)
      load_feat_tile<D>(fbuf + (buf ^ 1) * D::FTILE, feat, (tile + stride) * D::ROWS, M, lane);
    cp_async_commit();
    const long long row0 = tile * D::ROWS;
    float dv[D::RT][2][3];
    if (rgb != nullptr) load_dirs(dirs, row0, g, M, dv);
    cp_async_wait<1>();
    __syncwarp();
    uint32_t ax[D::RT][D::KIN / 16][4];
    feat_frags<D>(fbuf + buf * D::FTILE, g, t, ax);
    float o[D::RT][2][4];
    uint32_t mask_h[D::RT];
    sigma_mlp<D>(ax, w, lane, o, mask_h);
#pragma unroll
    for (int r = 0; r < D::RT; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long m = row0 + r * 16 + g + 8 * hh;
        if (m >= M) continue;
        if (t == 0) sigma[m] = expf(o[r][0][2 * hh]);  // trunc_exp's forward
        // the density logit, already rounded to bf16 like the plain version's
        if (t == 0 && raw != nullptr) raw[m] = o[r][0][2 * hh];
        if (geo != nullptr) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int col = 8 * j + 2 * t + q;
              if (col >= 1) geo[m * (D::OUT1 - 1) + col - 1] = o[r][j][2 * hh + q];
            }
        }
      }
    if (rgb != nullptr) {
      float c3[D::RT][1][4];
      uint32_t mask_c1[D::RT], mask_c2[D::RT];
      colour_mlp<D>(dv, o, w, lane, t, c3, mask_c1, mask_c2);
#pragma unroll
      for (int r = 0; r < D::RT; ++r)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long m = row0 + r * 16 + g + 8 * hh;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = 2 * t + q;
            if (m < M && col < 3) rgb[m * 3 + col] = sigmoid_of(bf16_round(c3[r][0][2 * hh + q]));
          }
        }
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
  }
  cp_async_wait<0>();
}

template <int IN, int HID, int OUT1, int HC>
int launch_fwd(const void* feat, const void* dirs, const void* wpack, void* sigma, void* geo,
               void* rgb, void* raw, long long M, long long smem, cudaStream_t s) {
  using D = FwdDims<IN, HID, OUT1, HC>;
  auto kernel = field_mma_fwd<D>;
  int blocks = 0;
  const int rc = persistent_blocks<D>(kernel, M, smem, &blocks);
  if (rc != 0) return rc;
  kernel<<<blocks, D::THREADS, D::SMEM, s>>>((const float*)feat, (const float*)dirs,
                                             (const __nv_bfloat16*)wpack, (float*)sigma,
                                             (float*)geo, (float*)rgb, (float*)raw, M);
  NGP_RETURN_LAST_ERROR();
}

}  // namespace

// wpack: the packed bf16 weights (models/ngp.py:pack_mlp_mma), 16-byte
// aligned.  raw: the density logit [M] fp32, or NULL.  Widths:
// NGP_MMA_WIDTHS (field_common.cuh).  smem: the plan's dynamic shared bytes
// (models/ngp.py:mma_launch; any other size is refused).
extern "C" int ngp_field_mma_raw(const void* feat, const void* dirs, const void* wpack,
                                 void* sigma, void* geo, void* rgb, void* raw, long long M,
                                 int in_dim, int hidden, int out1, int hidden_color,
                                 long long smem, void* stream) {
  if (M == 0) return 0;
  if (rgb != nullptr && dirs == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NGP_DISPATCH(IN, HID, OUT1, HC)                                     \
  if (in_dim == IN && hidden == HID && out1 == OUT1 && hidden_color == HC) \
    return launch_fwd<IN, HID, OUT1, HC>(feat, dirs, wpack, sigma, geo, rgb, raw, M, smem, s);
  NGP_MMA_WIDTHS(NGP_DISPATCH)
#undef NGP_DISPATCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int ngp_field_mma(const void* feat, const void* dirs, const void* wpack, void* sigma,
                             void* geo, void* rgb, long long M, int in_dim, int hidden, int out1,
                             int hidden_color, long long smem, void* stream) {
  return ngp_field_mma_raw(feat, dirs, wpack, sigma, geo, rgb, nullptr, M, in_dim, hidden, out1,
                           hidden_color, smem, stream);
}

// The forward's compiled plan at these widths (plan_of: threads, shared
// bytes, blocks an SM, registers, local bytes), for models/ngp.py:mma_plan.
template <int IN, int HID, int OUT1, int HC>
static int plan_at(long long* out) {
  using D = FwdDims<IN, HID, OUT1, HC>;
  return plan_of<D>(field_mma_fwd<D>, out);
}

extern "C" int ngp_field_mma_plan(int in_dim, int hidden, int out1, int hidden_color,
                                  long long* out) {
#define NGP_DISPATCH(IN, HID, OUT1, HC)                                     \
  if (in_dim == IN && hidden == HID && out1 == OUT1 && hidden_color == HC) \
    return plan_at<IN, HID, OUT1, HC>(out);
  NGP_MMA_WIDTHS(NGP_DISPATCH)
#undef NGP_DISPATCH
  return (int)cudaErrorInvalidValue;
}
