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
// sincosf (sinf's and cosf's accuracy), not the __sinf / __sincosf
// intrinsics: the arguments reach 2^9 pi ~ 1608 rad, where the intrinsics'
// error is large.
//
// Nothing upstream of this input takes a gradient (the backbone is frozen
// and the message is data), so there is no backward.
//
// What bounds it on the H100: bytes.  A sample reads x, d, rgb (36 B) and
// raw (4 B) and writes 88 + D floats (480 B at D = 32): M x 520 B at
// 3.35 TB/s.  Its 42 angles a sample, each a sine and a cosine, are far
// below the FP32 rate.
//
// Design: a block stages ROWS whole rows of the [M, 88 + D] row-major
// output in shared memory, then writes them as one contiguous span with
// 16-byte stores (4-byte ones where (88 + D) % 4 != 0).
// - The angles: one thread a (sample, channel, frequency), 30 position and
//   12 direction angles a sample; it computes the sine and the cosine of
//   its angle together (sincosf: one argument reduction) and puts them in
//   their two columns.  Item a of the block is row a / 42, angle a % 42 (a
//   constant divisor); within a sample, angle q < 30 is channel q / 10 and
//   frequency q % 10 at sine column q, cosine column 30 + q, and q >= 30
//   is channel (q - 30) / 4 and frequency (q - 30) % 4 at columns 30 + q
//   and 42 + q: freq_encode's channel-major layout.
// - rgb and raw: one thread a value, columns 84..87.
// - The message: staged in shared memory once a block as 1.0f / -1.0f;
//   each thread takes one column (its one divide by D, outside the loop)
//   and every ROWS-th row of it.
// No per-element integer divide by a runtime width remains: the rows are
// laid out and stored by offsets alone.  ROWS is the most rows (at most 64)
// whose floats and the message fit in 48 KB (the C entry point picks it).
// A bit that is not 0 counts as 1.

#include "common.cuh"

namespace {

constexpr int K_POS = 10;             // position frequencies
constexpr int K_DIR = 4;              // direction frequencies
constexpr int N_POS = 3 * 2 * K_POS;  // 60
constexpr int N_DIR = 3 * 2 * K_DIR;  // 24
constexpr int N_FIXED = N_POS + N_DIR + 4;
constexpr int N_ANG = 3 * K_POS + 3 * K_DIR;  // 42 angles a sample
constexpr int MAX_ROWS = 64;
constexpr int THREADS = 256;
constexpr int MAX_BITS = 1024;
constexpr int SMEM_BYTES = 48 * 1024;

// fp32(2^k) * fp32(pi), exact in fp32 (a power of two times fp32(pi))
__device__ __forceinline__ float freq(int k) { return ldexpf(3.14159265358979323846f, k); }

__global__ void __launch_bounds__(THREADS)
    copyrnerf_input(const float* __restrict__ x, const float* __restrict__ d,
                    const float* __restrict__ rgb, const float* __restrict__ raw,
                    const int* __restrict__ message, int D, float bound,
                    float* __restrict__ out, long long M, int rows_per_block) {
  extern __shared__ __align__(16) float row_s[];  // [rows][W], then the message [D]
  const int W = N_FIXED + D;
  float* msg_s = row_s + rows_per_block * W;
  const int t = threadIdx.x;
  for (int j = t; j < D; j += THREADS) msg_s[j] = message[j] != 0 ? 1.0f : -1.0f;
  const long long m0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, M - m0);
  const float two_bound = 2.0f * bound;
  for (int a = t; a < rows * N_ANG; a += THREADS) {
    const int r = a / N_ANG, q = a - r * N_ANG;
    const long long m = m0 + r;
    const bool pos = q < 3 * K_POS;
    float p;
    int k;
    if (pos) {
      const int c = q / K_POS;
      k = q - c * K_POS;
      const float x01 = (x[m * 3 + c] + bound) / two_bound;
      p = 2.0f * x01 - 1.0f;
    } else {
      const int c = (q - 3 * K_POS) / K_DIR;
      k = q - 3 * K_POS - c * K_DIR;
      p = d[m * 3 + c];
    }
    float sn, cs;
    sincosf(p * freq(k), &sn, &cs);
    float* row = row_s + r * W;
    const int col = pos ? q : 3 * K_POS + q;  // the sine's column
    row[col] = sn;
    row[col + (pos ? 3 * K_POS : 3 * K_DIR)] = cs;
  }
  for (int a = t; a < rows * 4; a += THREADS) {
    const int r = a >> 2, j = a & 3;
    const long long m = m0 + r;
    row_s[r * W + N_POS + N_DIR + j] = j < 3 ? rgb[m * 3 + j] : raw[m];
  }
  __syncthreads();  // the message staged
  if (D > 0) {
    if (D <= THREADS) {
      const int step = THREADS / D, r0 = t / D, j = t - r0 * D;
      if (r0 < step) {
        const float v = msg_s[j];
        for (int r = r0; r < rows; r += step) row_s[r * W + N_FIXED + j] = v;
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        for (int j = t; j < D; j += THREADS) row_s[r * W + N_FIXED + j] = msg_s[j];
      }
    }
  }
  __syncthreads();
  // the block's rows are out[m0 * W : (m0 + rows) * W]
  const int n = rows * W;
  if ((W & 3) == 0) {
    float4* o4 = reinterpret_cast<float4*>(out + m0 * W);
    const float4* s4 = reinterpret_cast<const float4*>(row_s);
    for (int i = t; i < n / 4; i += THREADS) o4[i] = s4[i];
  } else {
    float* o = out + m0 * W;
    for (int i = t; i < n; i += THREADS) o[i] = row_s[i];
  }
}

}  // namespace

// x, d, rgb [M, 3], raw [M] fp32; message [D] int32 (0/1); out [M, 88 + D]
// fp32, 16-byte aligned.  D <= 1024.
extern "C" int ngp_copyrnerf_input(const void* x, const void* d, const void* rgb,
                                   const void* raw, const void* message, int D, float bound,
                                   void* out, long long M, void* stream) {
  if (M == 0) return 0;
  if (D < 0 || D > MAX_BITS || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const int W = N_FIXED + D;
  int rows = (SMEM_BYTES / 4 - D) / W;
  rows = rows < MAX_ROWS ? rows : MAX_ROWS;
  const size_t smem = sizeof(float) * ((size_t)rows * W + D);
  copyrnerf_input<<<ngp_blocks(M, rows), THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)d, (const float*)rgb, (const float*)raw,
      (const int*)message, D, bound, (float*)out, M, rows);
  NGP_RETURN_LAST_ERROR();
}
