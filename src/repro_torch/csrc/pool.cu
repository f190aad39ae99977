// 2x2/2 max pool + 2-bit argmax (paper §III.D, Fig. 5), on f32 and on the
// int16 (Q7.8) feature maps of the fxp16 path.
//
// Replaces: src/repro/kernels/pool/pool.py, maxpool_fwd_pallas, and its
// int16 instance pinned by src/repro/kernels/pool/fxp.py, maxpool_fwd_fxp.
//
// x [N, H, W, C] -> y [N, H/2, W/2, C] and idx [N, H/2, W/2, ceil(C/4)],
// crumb j of byte b = argmax of channel 4b+j over the window candidates in
// the order (0,0), (0,1), (1,0), (1,1).  The scan replaces only on a
// strictly greater value, so ties go to the first candidate, as jnp.argmax
// does; ties are the common case (all-zero post-ReLU windows, and more so
// on the int16 grid), so this is what keeps the crumbs bitwise equal to the
// reference.
//
// Bound on an H100: bytes (reads sizeof(T) B, writes sizeof(T)/4 B + 1/16 B
// per input element; three compares).  Design: one thread per output crumb
// byte covers four channels of one window, so neighbouring threads read
// neighbouring runs of each candidate row; each byte has one writer, no
// shared memory, no atomics.

#include "common.cuh"

namespace {

template <typename T>
__global__ void maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   uint8_t* __restrict__ idx, int n, int h,
                                   int w, int c, int cb) {
  const int ho = h / 2, wo = w / 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * ho * wo * cb) return;
  const int b = t % cb, pix = t / cb;            // pix = (nn*ho + i)*wo + j
  const int j = pix % wo, i = (pix / wo) % ho, nn = pix / (wo * ho);
  const T* c00 = x + ((static_cast<size_t>(nn) * h + 2 * i) * w + 2 * j) * c;
  const size_t row = static_cast<size_t>(w) * c;
  const T* cand[4] = {c00, c00 + c, c00 + row, c00 + row + c};
  T* yp = y + static_cast<size_t>(pix) * c;
  uint32_t byte = 0;
  for (int q = 0; q < 4; ++q) {
    const int ch = 4 * b + q;
    if (ch >= c) break;
    T best = cand[0][ch];
    int k = 0;
#pragma unroll
    for (int kk = 1; kk < 4; ++kk) {
      const T v = cand[kk][ch];
      if (v > best) {          // strict: the first maximum wins
        best = v;
        k = kk;
      }
    }
    yp[ch] = best;
    byte |= static_cast<uint32_t>(k) << (2 * q);
  }
  idx[t] = static_cast<uint8_t>(byte);
}

template <typename T>
int maxpool_fwd(const T* x, T* y, uint8_t* idx, int n, int h, int w, int c,
                cudaStream_t stream) {
  const int cb = (c + 3) / 4;
  const int total = n * (h / 2) * (w / 2) * cb, threads = 256;
  maxpool_fwd_kernel<T>
      <<<(total + threads - 1) / threads, threads, 0, stream>>>(x, y, idx, n,
                                                                h, w, c, cb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_API int repro_maxpool_fwd(const float* x, float* y, uint8_t* idx, int n,
                                int h, int w, int c, cudaStream_t stream) {
  return maxpool_fwd<float>(x, y, idx, n, h, w, c, stream);
}

REPRO_API int repro_maxpool_fwd_i16(const int16_t* x, int16_t* y,
                                    uint8_t* idx, int n, int h, int w, int c,
                                    cudaStream_t stream) {
  return maxpool_fwd<int16_t>(x, y, idx, n, h, w, c, stream);
}
