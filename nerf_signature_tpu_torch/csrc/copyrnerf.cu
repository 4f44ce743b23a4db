// K10: the CopyRNeRF baseline's per-sample MLP input, forward only.
//
// Replaces the concatenation that nerf_signature_tpu/models/copyrnerf.py:
// copyrnerf_color (lines 68-108) builds before its first product:
//   x01 = (x + bound) / (2 bound)            (models/watermark.py:wtmk_field)
//   [freq_encode(2 x01 - 1, 10) 60, freq_encode(d, 4) 24, rgb 3, raw 1,
//    2 m - 1 (message broadcast) D]
// where freq_encode(p, K)[.., c K + k] = sin(p_c * 2^k pi) for the C K sines
// (channel-major), then the C K cosines in the same order, and the
// frequencies are fp32 (2^k times pi rounded to fp32, exactly as numpy
// makes them).  Every value is computed with JAX's operations in JAX's
// order; the file is compiled with -fmad=false, so nothing is contracted.
// sinf/cosf, not the __sinf intrinsics: the arguments reach 2^9 pi ~ 1608
// rad, where the intrinsics' error is large.
//
// Nothing upstream of this input takes a gradient (the backbone is frozen
// and the message is data), so there is no backward.
//
// What bounds it on the H100: bytes.  A sample reads x, d, rgb (36 B) and
// raw (4 B) and writes 88 + D floats (480 B at D = 32): M x 520 B at
// 3.35 TB/s.  Its 84 sines and cosines a sample are far below the FP32 rate.
//
// Design: one thread an output element, so a warp's stores are 128
// consecutive bytes of the [M, 88 + D] row-major output.  A block owns
// ROWS consecutive samples; its threads walk the block's ROWS x W elements
// (int32 index arithmetic inside the block), and the inputs of a sample,
// read by all of its W threads, come through L1.  The message bits are
// staged in shared memory once a block.  A bit that is not 0 counts as 1.

#include "common.cuh"

namespace {

constexpr int K_POS = 10;             // position frequencies
constexpr int K_DIR = 4;              // direction frequencies
constexpr int N_POS = 3 * 2 * K_POS;  // 60
constexpr int N_DIR = 3 * 2 * K_DIR;  // 24
constexpr int N_FIXED = N_POS + N_DIR + 4;
constexpr int ROWS = 32;
constexpr int THREADS = 256;
constexpr int MAX_BITS = 1024;

// fp32(2^k) * fp32(pi), exact in fp32 (a power of two times fp32(pi))
__device__ __forceinline__ float freq(int k) { return ldexpf(3.14159265358979323846f, k); }

__global__ void __launch_bounds__(THREADS)
    copyrnerf_input(const float* __restrict__ x, const float* __restrict__ d,
                    const float* __restrict__ rgb, const float* __restrict__ raw,
                    const int* __restrict__ message, int D, float bound,
                    float* __restrict__ out, long long M) {
  __shared__ float msg_s[MAX_BITS];
  for (int i = threadIdx.x; i < D; i += blockDim.x) msg_s[i] = message[i] != 0 ? 1.0f : -1.0f;
  __syncthreads();
  const int W = N_FIXED + D;
  const long long m0 = (long long)blockIdx.x * ROWS;
  const int rows = (int)min((long long)ROWS, M - m0);
  const float two_bound = 2.0f * bound;
  for (int e = threadIdx.x; e < rows * W; e += blockDim.x) {
    const int r = e / W;
    const int j = e - r * W;
    const long long m = m0 + r;
    float v;
    if (j < N_POS + N_DIR) {
      const bool pos = j < N_POS;
      const int K = pos ? K_POS : K_DIR;
      const int jj = pos ? j : j - N_POS;
      const int half = 3 * K;
      const bool is_cos = jj >= half;
      const int ck = is_cos ? jj - half : jj;
      const int c = ck / K, k = ck - c * K;
      float p;
      if (pos) {
        const float x01 = (x[m * 3 + c] + bound) / two_bound;
        p = 2.0f * x01 - 1.0f;
      } else {
        p = d[m * 3 + c];
      }
      const float ang = p * freq(k);
      v = is_cos ? cosf(ang) : sinf(ang);
    } else if (j < N_POS + N_DIR + 3) {
      v = rgb[m * 3 + (j - N_POS - N_DIR)];
    } else if (j == N_POS + N_DIR + 3) {
      v = raw[m];
    } else {
      v = msg_s[j - N_FIXED];
    }
    out[m * W + j] = v;
  }
}

}  // namespace

// x, d, rgb [M, 3], raw [M] fp32; message [D] int32 (0/1); out [M, 88 + D]
// fp32.  D <= 1024.
extern "C" int ngp_copyrnerf_input(const void* x, const void* d, const void* rgb,
                                   const void* raw, const void* message, int D, float bound,
                                   void* out, long long M, void* stream) {
  if (M == 0) return 0;
  if (D < 0 || D > MAX_BITS) return (int)cudaErrorInvalidValue;
  copyrnerf_input<<<ngp_blocks(M, ROWS), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)d, (const float*)rgb, (const float*)raw,
      (const int*)message, D, bound, (float*)out, M);
  NGP_RETURN_LAST_ERROR();
}
