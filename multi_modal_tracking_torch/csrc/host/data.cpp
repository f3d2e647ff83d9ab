// Host data library of the training input pipeline, with a plain C ABI
// (bound with ctypes in multi_modal_tracking_torch/native/__init__.py).
//
// Every entry point computes what the port's numpy code computes, bit for
// bit (tests/test_torch_port_native_data.py):
//   mmt_sample_target       train/data/processing_utils.py sample_target and
//                           resize_linear (cv2 INTER_LINEAR, 8-bit fixed
//                           point), the padding mask and processing.py
//                           _att_mask_valid, reading the frame through the
//                           joint augmentation's grey and mirror flags
//                           (transforms.py JointAugment.apply_image_pair),
//                           for one frame or an RGB-T pair;
//   mmt_jitter_jet_normalise transforms.py tensor_and_jitter_rgbt (+ the
//                           pixel half of flip_norm), float32 operation by
//                           operation;
//   mmt_apply_jet           ops/colormap.py apply_jet_np.
//
// Built with g++ -O3 -fPIC -std=c++17 -shared -ffp-contract=off: no
// -ffast-math, no -march=native, and no contraction to FMA, each of which
// would change float32 bits. Nothing here touches Python objects, so each
// call runs with the interpreter lock released.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// cv2's RGB2GRAY / BGR2GRAY 15-bit fixed point, rounding to nearest
inline int grey(int w0, int w1, int w2) {
  return (9798 * w0 + 19235 * w1 + 3735 * w2 + (1 << 14)) >> 15;
}

// colormap.py's closed form of cv2's JET table, one BGR entry
inline void jet_entry(int i, uint8_t bgr[3]) {
  auto clamp255 = [](int v) { return std::min(std::max(v, 0), 255); };
  bgr[0] = static_cast<uint8_t>(clamp255(std::min(4 * i + 128, -4 * i + 638)) - (i == 159));
  bgr[1] = static_cast<uint8_t>(clamp255(std::min(4 * i - 128, -4 * i + 892)));
  bgr[2] = static_cast<uint8_t>(clamp255(std::min(4 * i - 382, -4 * i + 1148)));
}

struct JetTable {
  uint8_t bgr[256][3];
  JetTable() {
    for (int i = 0; i < 256; ++i) jet_entry(i, bgr[i]);
  }
};
const JetTable JET;

// processing_utils._linear_taps: sample positions (d + 0.5) * src/dst - 0.5
// in double rounded to float32; x clamps (weight 0 on the missing tap)
struct Taps {
  std::vector<int> i0, i1;
  std::vector<float> frac;
};

Taps linear_taps(int src, int dst, bool clamp) {
  Taps t;
  t.i0.resize(dst);
  t.i1.resize(dst);
  t.frac.resize(dst);
  const double scale = 1.0 / (static_cast<double>(dst) / static_cast<double>(src));
  for (int d = 0; d < dst; ++d) {
    const float f = static_cast<float>((static_cast<double>(d) + 0.5) * scale - 0.5);
    const float fl = std::floor(f);
    float fr = f - fl;
    const long long k = static_cast<long long>(fl);
    if (clamp && (k < 0 || k >= src - 1)) fr = 0.0f;
    t.i0[d] = static_cast<int>(std::min<long long>(std::max<long long>(k, 0), src - 1));
    t.i1[d] = static_cast<int>(std::min<long long>(std::max<long long>(k + 1, 0), src - 1));
    t.frac[d] = fr;
  }
  return t;
}

// processing_utils._fixed_coefs: 11-bit coefficients, rint half to even
inline int fixed0(float fr) { return static_cast<int>(std::nearbyint((1.0f - fr) * 2048.0f)); }
inline int fixed1(float fr) { return static_cast<int>(std::nearbyint(fr * 2048.0f)); }

// Python's slice [start:stop] on an axis of length n: (first index, length)
void py_slice(long long start, long long stop, long long n, long long* first, long long* len) {
  if (start < 0) start = std::max(start + n, 0LL);
  else start = std::min(start, n);
  if (stop < 0) stop = std::max(stop + n, 0LL);
  else stop = std::min(stop, n);
  *first = start;
  *len = std::max(stop - start, 0LL);
}

}  // namespace

extern "C" {

// Square crop of side ceil(sqrt(w h) factor) around the box (x, y, w, h),
// zero padding outside the frame (with sample_target's last-row/column
// quirk), resized to out_sz x out_sz as cv2 INTER_LINEAR on uint8.
//
// img: (H, W, C) uint8, C-contiguous, the frame BEFORE the joint
// augmentation; gray (C == 3 only) reads each pixel as cv2's RGB2GRAY of
// it on all channels, flip reads column W - 1 - c for column c. The box is
// in the augmented frame's coordinates. img2 (or null): a second frame of
// the same shape cropped at the same window into crop2 without gray (the
// TIR frame of an RGB-T pair: both crops share their window and mask).
// crop, crop2: (out_sz, out_sz, C) uint8. mask: (out_sz, out_sz) uint8 or
// null, the resized padding mask (1 on padding). *valid: processing.py
// _att_mask_valid of that mask.
// Returns 0, or 1 for a box too small (crop side < 1, or not a number),
// 2 for a window with no frame pixel, 3 for bad arguments; sample_target
// raises ValueError for 1 and 2.
int mmt_sample_target(const uint8_t* img, const uint8_t* img2, int H, int W, int C, int gray,
                      int flip, double x, double y, double w, double h, double factor,
                      int out_sz, uint8_t* crop, uint8_t* crop2, uint8_t* mask, int* valid) {
  if (H < 1 || W < 1 || C < 1 || out_sz < 1 || (gray && C != 3) || (img2 && !crop2)) return 3;
  const double side = std::ceil(std::sqrt(w * h) * factor);
  if (!(side >= 1.0) || !std::isfinite(side)) return 1;
  const long long crop_sz = static_cast<long long>(side);
  const long long x1 = static_cast<long long>(std::nearbyint(x + 0.5 * w - crop_sz * 0.5));
  const long long x2 = x1 + crop_sz;
  const long long y1 = static_cast<long long>(std::nearbyint(y + 0.5 * h - crop_sz * 0.5));
  const long long y2 = y1 + crop_sz;
  const long long x1_pad = std::max(0LL, -x1), x2_pad = std::max(x2 - W + 1, 0LL);
  const long long y1_pad = std::max(0LL, -y1), y2_pad = std::max(y2 - H + 1, 0LL);
  long long xs, nx, ys, ny;
  py_slice(x1 + x1_pad, x2 - x2_pad, W, &xs, &nx);
  py_slice(y1 + y1_pad, y2 - y2_pad, H, &ys, &ny);
  if (nx == 0 || ny == 0) return 2;
  const int Hp = static_cast<int>(ny + y1_pad + y2_pad);
  const int Wp = static_cast<int>(nx + x1_pad + x2_pad);

  const Taps tx = linear_taps(Wp, out_sz, true);
  const Taps ty = linear_taps(Hp, out_sz, false);
  // each output column's two source columns in the frame (-1: padding)
  std::vector<int> col0(out_sz), col1(out_sz), a0(out_sz), a1(out_sz);
  auto frame_col = [&](int px) -> int {
    const long long c = px - x1_pad;
    if (c < 0 || c >= nx) return -1;
    return static_cast<int>(flip ? W - 1 - (xs + c) : xs + c);
  };
  for (int d = 0; d < out_sz; ++d) {
    col0[d] = frame_col(tx.i0[d]);
    col1[d] = frame_col(tx.i1[d]);
    a0[d] = fixed0(tx.frac[d]);
    a1[d] = fixed1(tx.frac[d]);
  }

  // horizontal pass of one padded row: (out_sz, C) values x 2048
  const int row_len = out_sz * C;
  std::vector<int> buf[2] = {std::vector<int>(row_len), std::vector<int>(row_len)};
  auto resize = [&](const uint8_t* src, bool grey_read, uint8_t* dst) {
    int tag[2] = {-1, -1};
    auto pixel = [&](const uint8_t* row, int col, int c) -> int {
      if (col < 0) return 0;
      const uint8_t* p = row + static_cast<size_t>(col) * C;
      return grey_read ? grey(p[0], p[1], p[2]) : p[c];
    };
    auto fill = [&](int py, int* out) {
      const long long r = py - y1_pad;
      if (r < 0 || r >= ny) {
        std::fill(out, out + row_len, 0);
        return;
      }
      const uint8_t* row = src + static_cast<size_t>(ys + r) * W * C;
      for (int d = 0; d < out_sz; ++d)
        for (int c = 0; c < C; ++c)
          out[d * C + c] = pixel(row, col0[d], c) * a0[d] + pixel(row, col1[d], c) * a1[d];
    };
    auto get = [&](int py, int keep) -> const int* {
      for (int s = 0; s < 2; ++s)
        if (tag[s] == py) return buf[s].data();
      const int s = tag[0] == keep ? 1 : 0;
      fill(py, buf[s].data());
      tag[s] = py;
      return buf[s].data();
    };
    for (int d = 0; d < out_sz; ++d) {
      const int b0 = fixed0(ty.frac[d]), b1 = fixed1(ty.frac[d]);
      const int* r0 = get(ty.i0[d], ty.i1[d]);
      const int* r1 = get(ty.i1[d], ty.i0[d]);
      uint8_t* o = dst + static_cast<size_t>(d) * row_len;
      for (int k = 0; k < row_len; ++k) {
        const int r = (((r0[k] >> 4) * b0) >> 16) + (((r1[k] >> 4) * b1) >> 16);
        o[k] = static_cast<uint8_t>(std::min(std::max((r + 2) >> 2, 0), 255));
      }
    }
  };
  resize(img, gray != 0, crop);
  if (img2) resize(img2, false, crop2);

  // the padding mask (1 outside the frame pixels), resized in double as
  // resize_linear resizes floats, then taken as nonzero
  std::vector<uint8_t> own;
  if (mask == nullptr) {
    own.resize(static_cast<size_t>(out_sz) * out_sz);
    mask = own.data();
  }
  auto pad_row = [&](int py) { return py < y1_pad || py >= y1_pad + ny; };
  auto pad_col = [&](int px) { return px < x1_pad || px >= x1_pad + nx; };
  bool all_pad = true;
  for (int dy = 0; dy < out_sz; ++dy) {
    const double fy = ty.frac[dy];
    const bool ry0 = pad_row(ty.i0[dy]), ry1 = pad_row(ty.i1[dy]);
    for (int dx = 0; dx < out_sz; ++dx) {
      const double fx = tx.frac[dx];
      const bool cx0 = pad_col(tx.i0[dx]), cx1 = pad_col(tx.i1[dx]);
      const double m0 = (ry0 || cx0 ? 1.0 : 0.0) * (1.0 - fx) + (ry0 || cx1 ? 1.0 : 0.0) * fx;
      const double m1 = (ry1 || cx0 ? 1.0 : 0.0) * (1.0 - fx) + (ry1 || cx1 ? 1.0 : 0.0) * fx;
      const bool m = m0 * (1.0 - fy) + m1 * fy != 0.0;
      mask[static_cast<size_t>(dy) * out_sz + dx] = m;
      all_pad = all_pad && m;
    }
  }
  // _att_mask_valid: not all padding, at full and at 1/16 resolution
  // (resize_nearest: source index floor(d * src/dst), at most src - 1)
  bool ok = !all_pad;
  const int o16 = out_sz / 16;
  if (ok) {
    bool all16 = true;
    const double step = 1.0 / (static_cast<double>(o16) / static_cast<double>(out_sz));
    for (int dy = 0; dy < o16 && all16; ++dy) {
      const long long sy = std::min(static_cast<long long>(std::floor(dy * step)),
                                    static_cast<long long>(out_sz - 1));
      for (int dx = 0; dx < o16 && all16; ++dx) {
        const long long sx = std::min(static_cast<long long>(std::floor(dx * step)),
                                      static_cast<long long>(out_sz - 1));
        all16 = mask[sy * out_sz + sx] != 0;
      }
    }
    ok = !all16;
  }
  *valid = ok;
  return 0;
}

// tensor_and_jitter_rgbt on one (h, w, 3) uint8 crop pair, then the pixel
// half of flip_norm when flip is set: out_v = (clip(f32(v) * f32(bf / 255),
// 0, 1) - mean) / std; out_i = (f32(jet(u8(clip(f32(i) * f32(tir_f), 0,
// 255)))) / 255 - mean) / std, with the JET map on cv2's BGR2GRAY of the
// TIR crop. out_v, out_i: (h, w, 3) float32.
void mmt_jitter_jet_normalise(const uint8_t* v, const uint8_t* i, int h, int w, double bf,
                              double tir_f, int flip, float* out_v, float* out_i) {
  // transforms.py IMAGENET_MEAN / IMAGENET_STD: Python floats rounded to float32
  const float mean[3] = {static_cast<float>(0.485), static_cast<float>(0.456),
                         static_cast<float>(0.406)};
  const float stdv[3] = {static_cast<float>(0.229), static_cast<float>(0.224),
                         static_cast<float>(0.225)};
  const float vs = static_cast<float>(bf / 255.0);
  const float ts = static_cast<float>(tir_f);
  for (int r = 0; r < h; ++r) {
    for (int c = 0; c < w; ++c) {
      const size_t src = (static_cast<size_t>(r) * w + c) * 3;
      const size_t dst = (static_cast<size_t>(r) * w + (flip ? w - 1 - c : c)) * 3;
      int u[3];
      for (int k = 0; k < 3; ++k) {
        const float a = std::min(std::max(static_cast<float>(v[src + k]) * vs, 0.0f), 1.0f);
        out_v[dst + k] = (a - mean[k]) / stdv[k];
        const float t = std::min(std::max(static_cast<float>(i[src + k]) * ts, 0.0f), 255.0f);
        u[k] = static_cast<int>(t);
      }
      const uint8_t* e = JET.bgr[std::min(grey(u[2], u[1], u[0]), 255)];
      for (int k = 0; k < 3; ++k)
        out_i[dst + k] = (static_cast<float>(e[k]) / 255.0f - mean[k]) / stdv[k];
    }
  }
}

// apply_jet_np: uint8 (h, w) (channels 1) or (h, w, 3) (channels 3, BGR2GRAY
// first) -> (h, w, 3) JET map, in cv2's BGR order or, with out_bgr 0, RGB.
void mmt_apply_jet(const uint8_t* src, int h, int w, int channels, uint8_t* dst, int out_bgr) {
  const size_t n = static_cast<size_t>(h) * w;
  for (size_t p = 0; p < n; ++p) {
    const int idx = channels == 3 ? grey(src[p * 3 + 2], src[p * 3 + 1], src[p * 3 + 0]) : src[p];
    const uint8_t* e = JET.bgr[std::min(idx, 255)];
    for (int k = 0; k < 3; ++k) dst[p * 3 + k] = e[out_bgr ? k : 2 - k];
  }
}

}  // extern "C"
