// Rigid (Euclidean) image registration by Gauss-Newton minimization of the
// sum of squared differences between a reference frame and a warped moving
// frame — the host-side C++ replacement for the reference's pystackreg
// (TurboReg) and OpenCV-ECC registration paths (motion.py:401-429,
// motion.py:575-642).
//
// C API:
//   int rigid_register(const float* ref, const float* img, int h, int w,
//                      int max_iters, float eps, float* warp /* 2x3 */);
// warp is initialized by the caller (usually identity) and refined in place;
// convention matches cv2 warps: dst(x,y) = img(W [x y 1]^T).

#include <cmath>
#include <cstring>
#include <vector>

namespace {

inline float bilinear(const float* im, int h, int w, float x, float y,
                      bool* inside) {
  int x0 = static_cast<int>(std::floor(x));
  int y0 = static_cast<int>(std::floor(y));
  if (x0 < 0 || y0 < 0 || x0 + 1 >= w || y0 + 1 >= h) {
    *inside = false;
    return 0.f;
  }
  *inside = true;
  float wx = x - x0, wy = y - y0;
  const float* r0 = im + y0 * w + x0;
  const float* r1 = r0 + w;
  float top = r0[0] * (1 - wx) + r0[1] * wx;
  float bot = r1[0] * (1 - wx) + r1[1] * wx;
  return top * (1 - wy) + bot * wy;
}

}  // namespace

extern "C" {

int rigid_register(const float* ref, const float* img, int h, int w,
                   int max_iters, float eps, float* warp) {
  // Parameterize as (theta, tx, ty) extracted from the initial warp.
  float theta = std::atan2(warp[3], warp[0]);
  float tx = warp[2];
  float ty = warp[5];

  // Precompute moving-image gradients (central differences).
  std::vector<float> gx(h * w, 0.f), gy(h * w, 0.f);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int i = y * w + x;
      if (x > 0 && x < w - 1) gx[i] = 0.5f * (img[i + 1] - img[i - 1]);
      if (y > 0 && y < h - 1) gy[i] = 0.5f * (img[i + w] - img[i - w]);
    }
  }

  for (int it = 0; it < max_iters; ++it) {
    float c = std::cos(theta), s = std::sin(theta);
    // Normal equations: H (3x3), b (3)
    double H[9] = {0}, b[3] = {0};
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        float xw = c * x - s * y + tx;
        float yw = s * x + c * y + ty;
        bool inside;
        float v = bilinear(img, h, w, xw, yw, &inside);
        if (!inside) continue;
        bool in2;
        float ix = bilinear(gx.data(), h, w, xw, yw, &in2);
        float iy = bilinear(gy.data(), h, w, xw, yw, &in2);
        float r = v - ref[y * w + x];
        // d(xw)/dtheta = -s*x - c*y ; d(yw)/dtheta = c*x - s*y
        float jt = ix * (-s * x - c * y) + iy * (c * x - s * y);
        float J[3] = {jt, ix, iy};
        for (int a = 0; a < 3; ++a) {
          b[a] += J[a] * r;
          for (int bb = 0; bb < 3; ++bb) H[a * 3 + bb] += J[a] * J[bb];
        }
      }
    }
    // Solve H d = -b (3x3 Gaussian elimination with partial pivoting).
    double A[12] = {H[0], H[1], H[2], -b[0],
                    H[3], H[4], H[5], -b[1],
                    H[6], H[7], H[8], -b[2]};
    for (int col = 0; col < 3; ++col) {
      int piv = col;
      for (int r2 = col + 1; r2 < 3; ++r2)
        if (std::fabs(A[r2 * 4 + col]) > std::fabs(A[piv * 4 + col]))
          piv = r2;
      if (std::fabs(A[piv * 4 + col]) < 1e-12) return 1;  // singular
      if (piv != col)
        for (int k = 0; k < 4; ++k) std::swap(A[col * 4 + k], A[piv * 4 + k]);
      for (int r2 = 0; r2 < 3; ++r2) {
        if (r2 == col) continue;
        double f = A[r2 * 4 + col] / A[col * 4 + col];
        for (int k = col; k < 4; ++k) A[r2 * 4 + k] -= f * A[col * 4 + k];
      }
    }
    double dt = A[3] / A[0], dx = A[7] / A[5], dy = A[11] / A[10];
    theta += static_cast<float>(dt);
    tx += static_cast<float>(dx);
    ty += static_cast<float>(dy);
    if (std::fabs(dt) < eps && std::fabs(dx) < eps * 10 &&
        std::fabs(dy) < eps * 10)
      break;
  }

  float c = std::cos(theta), s = std::sin(theta);
  warp[0] = c;  warp[1] = -s; warp[2] = tx;
  warp[3] = s;  warp[4] = c;  warp[5] = ty;
  return 0;
}

}  // extern "C"
